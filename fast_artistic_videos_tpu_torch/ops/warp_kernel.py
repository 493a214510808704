"""K1: the banded bilinear warp — wrapper of ``csrc/warp_banded.cu`` and
its plain PyTorch version.

Replaces ``fast_artistic_videos_tpu/ops/warp_pallas.py`` ``_vpass_kernel``.
Semantics are those of ``ops/warp.py`` ``_warp_banded_single`` in the JAX
package: a vertical two-tap pass by dy, then a horizontal two-tap pass by
dx over the vertical result (so a displaced column's OWN dy is used — the
documented composition approximation), each tap reading zero when its shift
lies outside [-band, band + 1] or its source lies outside the image. Work is
in float32 for float32 or bfloat16 input; the result is cast back.

Two C entries (:func:`warp_route`): ``fav_warp_banded_vec`` takes one
16-byte channel vector a thread where C allows it (every feature and delta
width) and one element a thread otherwise; ``fav_warp_banded`` one pixel a
thread for C <= 4 (the flow, RGB frames). Each launch adds one to
``KERNEL.launches`` and to ``KERNEL.routes`` of its entry.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from ._build import Kernel, graph_break, no_grad_inputs, ptr

KERNEL = Kernel("warp_banded", "fast_artistic_videos_tpu_torch/csrc/warp_banded.cu",
                "fast_artistic_videos_tpu/ops/warp_pallas.py:32", "kernel.K1")
PIXEL_ENTRY = "fav_warp_banded"
VEC_ENTRY = "fav_warp_banded_vec"
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's limits: 32-bit element offsets, rows and images on the grid's
# y and z axes, channels, band
_MAX_ELEMENTS, _MAX_GRID, _MAX_C, _MAX_BAND = 2 ** 31, 65535, 1024, 2 ** 24


def _banded_pass(x, off, band: int, dim: int):
    """One two-tap pass along `dim` (1 = rows, 2 = cols) of x (N, H, W, C)
    float32 by the per-pixel offset `off` (N, H, W)."""
    n = x.shape[dim]
    base = torch.floor(off)
    w0 = 1.0 - (off - base)
    s0 = base.to(torch.int64)
    shape = [1, 1, 1]
    shape[dim] = n
    pos = torch.arange(n, device=x.device).view(shape)
    out = torch.zeros_like(x)
    for j, wj in ((0, w0), (1, 1.0 - w0)):
        s = s0 + j
        src = pos + s
        ok = (s >= -band) & (s <= band + 1) & (src >= 0) & (src < n)
        idx = src.clamp(0, n - 1).unsqueeze(-1).expand(x.shape)
        g = torch.gather(x, dim, idx)
        out = out + g * (wj * ok)[..., None]
    return out


def warp_banded_plain(img, flow, band: int):
    """img (N, H, W, C) float32/bfloat16, flow (N, H, W, 2) (dx, dy)."""
    x = img.float()
    f = flow.float()
    v = _banded_pass(x, f[..., 1], band, 1)
    return _banded_pass(v, f[..., 0], band, 2).to(img.dtype)


def warp_route(c: int, dtype, aligned: bool = True):
    """(C entry, elements a thread loads per tap) of K1 for C channels of
    `dtype` (float32 or bfloat16), an image 16-byte aligned or not: a
    pure function. ``fav_warp_banded_vec`` with a 16-byte channel vector a
    thread (4 float32 or 8 bfloat16) where C is a multiple of it and the
    image aligned; else ``fav_warp_banded`` with one pixel's C <= 4
    channels a thread (flow, RGB); else ``fav_warp_banded_vec`` with one
    element a thread (the scalar path)."""
    vec = 16 // dtype.itemsize
    if aligned and c % vec == 0:
        return VEC_ENTRY, vec
    if c <= 4:
        return PIXEL_ENTRY, c
    return VEC_ENTRY, 1


@graph_break
def warp_banded(img, flow, band: int):
    """K1. img (N, H, W, C) float32 or bfloat16; flow (N, H, W, 2) float32
    (dx, dy). A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the entry :func:`warp_route` names, or raises. Raises on any
    device when asked to carry a gradient (``_build.no_grad_inputs``)."""
    no_grad_inputs("warp_banded", img, flow)
    if img.device.type == "cpu":
        return warp_banded_plain(img, flow, band)
    with profiling.span(KERNEL.span):
        return _launch(img, flow, band)


def _launch(img, flow, band: int):
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(f"warp_banded: img on {img.device}, flow on {flow.device}")
    dtype = img.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"warp_banded: unsupported dtype {dtype}")
    if flow.dtype != torch.float32:
        raise TypeError("warp_banded: flow must be float32")
    if img.ndim != 4 or flow.shape != img.shape[:3] + (2,):
        raise ValueError(f"warp_banded: shapes {tuple(img.shape)} / {tuple(flow.shape)}")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp_banded: inputs must be contiguous")
    n, h, w, c = img.shape
    if img.numel() >= _MAX_ELEMENTS or n > _MAX_GRID or h > _MAX_GRID or c > _MAX_C:
        raise ValueError(f"warp_banded: shape {tuple(img.shape)} beyond the kernel's 32-bit "
                         f"offsets, grid or {_MAX_C} channels")
    if not 0 <= band <= _MAX_BAND:
        raise ValueError(f"warp_banded: band {band} outside [0, {_MAX_BAND}]")
    out = torch.empty_like(img)
    if out.numel():
        entry, vec = warp_route(c, dtype, img.data_ptr() % 16 == 0)
        args = (ptr(img), ptr(flow), ptr(out), n, h, w, c, int(band), int(dtype == torch.bfloat16))
        if entry == VEC_ENTRY:
            KERNEL.call(entry, img.device, *args, vec)
        else:
            KERNEL.call(entry, img.device, *args)
    return out
