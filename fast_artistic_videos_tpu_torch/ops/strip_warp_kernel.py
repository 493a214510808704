"""K5: the static separable-projective strip warp of the VR border maps —
wrapper of ``csrc/strip_warp.cu`` and its plain PyTorch version.

Replaces ``fast_artistic_videos_tpu/ops/warp_pallas.py`` ``_strip_kernel``
(factory ``make_static_strip_warp``). The VR border maps
(``video/vr_geometry.py``) touch only an overlap-wide strip of the output,
and their projective structure makes one source coordinate constant along
one axis: the left/right maps' source column depends on the output column
only, the top/bottom maps' source row on the output row only. The factory
checks that structure on the host (returning None when it is absent, so the
caller falls back to ``ops.warp.make_static_warp``) and builds static
tables over the output's bounding box of mapped pixels:

  * the "line" axis (output column for left/right, output row for
    top/bottom): one source index (floor) and its bilinear fraction;
  * the "pixel" axis: per output pixel, the source index (floor) on the
    other axis and its fraction. Unmapped pixels get an index whose two taps
    both lie outside the image, so they read zero.

Then, per output pixel, with p the pixel-axis taps and q the line-axis taps:

    A(p) = (1 - fq) * S(p, q0) + fq * S(p, q0 + 1)
    out  = (1 - fp) * A(p0)    + fp * A(p0 + 1)

(the Pallas kernel's column stage, then its 2-tap row resample), where S
reads zero outside the source image. That equals ``bilinear_warp(img,
map)`` on these maps. The output is the whole (Ho, Wo, C) frame in float32,
zero outside the strip; the input is float32 or bfloat16.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ._build import Kernel, ptr

KERNEL = Kernel("strip_warp", "fast_artistic_videos_tpu_torch/csrc/strip_warp.cu",
                "fast_artistic_videos_tpu/ops/warp_pallas.py:142")

_UNMAPPED = -4      # a floor index whose two taps both fall outside the image


class StripWarp:
    """The warp of one static map: ``warp(img)`` with img (H, W, C) or
    (N, H, W, C) (a batch shares the map) returns float32 (Ho, Wo, C) or
    (N, Ho, Wo, C). A CPU tensor runs the plain version; a CUDA tensor
    launches kernel K5 or raises. The tables are uploaded once per device,
    at the first call on it."""

    def __init__(self, out_hw, box, transposed, pix_src, pix_frac, line_src, line_frac):
        self.out_hw = tuple(out_hw)
        self.box = box                      # (y0, y1, x0, x1) of the output
        self.transposed = transposed        # True: the line axis is the row
        self._host = (pix_src, pix_frac, line_src, line_frac)
        self._tables = {}
        self._lock = threading.Lock()

    def tables(self, device):
        """(pix_src int32, pix_frac f32, line_src int32, line_frac f32) on
        `device`, the pixel tables (bh, bw) over the box in the output frame."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            got = self._tables.get(device)
            if got is None:
                got = tuple(torch.from_numpy(a).to(device) for a in self._host)
                self._tables[device] = got
            return got

    def __call__(self, img):
        if img.device.type == "cpu":
            return self.plain(img)
        if img.device.type != "cuda":
            raise ValueError(f"strip_warp: img on {img.device}")
        return self.kernel(img)

    def _batch(self, img):
        if img.ndim not in (3, 4):
            raise ValueError(f"strip_warp: img must be HWC or NHWC, got {tuple(img.shape)}")
        return img.ndim == 3, (img[None] if img.ndim == 3 else img)

    def plain(self, img):
        """The same tables, applied with torch indexing in float32."""
        single, x = self._batch(img)
        n, h, w, c = x.shape
        y0, y1, x0, x1 = self.box
        pix_src, pix_frac, line_src, line_frac = self.tables(x.device)
        bh, bw = y1 - y0, x1 - x0
        line_src = line_src.long()
        line_src = line_src[:, None] if self.transposed else line_src[None, :]
        line_frac = line_frac[:, None] if self.transposed else line_frac[None, :]
        pix_src = pix_src.long()
        flat = x.float().reshape(n, h * w, c)
        p_end, q_end = (w, h) if self.transposed else (h, w)

        def tap(p, q):
            """S(p, q): pixel-axis index p, line-axis index q, zero outside."""
            p, q = torch.broadcast_tensors(p, q)
            ok = (p >= 0) & (p < p_end) & (q >= 0) & (q < q_end)
            r, col = (q, p) if self.transposed else (p, q)
            idx = (r.clamp(0, h - 1) * w + col.clamp(0, w - 1)).reshape(-1)
            vals = flat[:, idx].reshape(n, bh, bw, c)
            return vals * ok[None, ..., None]

        fq = line_frac[None, ..., None]
        fp = pix_frac[None, ..., None]
        a0 = (1.0 - fq) * tap(pix_src, line_src) + fq * tap(pix_src, line_src + 1)
        a1 = (1.0 - fq) * tap(pix_src + 1, line_src) + fq * tap(pix_src + 1, line_src + 1)
        strip = (1.0 - fp) * a0 + fp * a1
        out = flat.new_zeros((n,) + self.out_hw + (c,))
        out[:, y0:y1, x0:x1] = strip
        return out[0] if single else out

    def kernel(self, img):
        """K5 on a CUDA tensor: one launch writes the whole output frame."""
        single, x = self._batch(img)
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"strip_warp: unsupported dtype {x.dtype}")
        x = x.contiguous()
        n, h, w, c = x.shape
        pix_src, pix_frac, line_src, line_frac = self.tables(x.device)
        y0, y1, x0, x1 = self.box
        out = torch.empty((n,) + self.out_hw + (c,), dtype=torch.float32, device=x.device)
        if out.numel():
            KERNEL.call("fav_strip_warp", x.device, ptr(x), ptr(pix_src), ptr(pix_frac),
                        ptr(line_src), ptr(line_frac), ptr(out), n, h, w, c,
                        self.out_hw[0], self.out_hw[1], y0, x0, y1 - y0, x1 - x0,
                        int(self.transposed), int(x.dtype == torch.bfloat16))
        return out[0] if single else out


def make_static_strip_warp(map_np, sentinel: float = 9999.0):
    """K5's factory for a static offset map (H, W, 2) (dx, dy): a
    :class:`StripWarp`, or None when the map is not separable-projective in
    either orientation (the host analysis of the JAX package's
    ``warp_pallas.make_static_strip_warp``)."""
    with warnings.catch_warnings():     # all-NaN columns of unmapped pixels
        warnings.simplefilter("ignore", RuntimeWarning)
        return _analyse(np.asarray(map_np, np.float64), sentinel)


def _analyse(map_np, sentinel):
    ho_f, wo_f = map_np.shape[:2]
    mapped_f = np.all(np.abs(map_np) < sentinel / 2, axis=-1)
    if not mapped_f.any():
        return None
    rows_any = np.where(mapped_f.any(axis=1))[0]
    cols_any = np.where(mapped_f.any(axis=0))[0]
    y0, y1 = int(rows_any[0]), int(rows_any[-1]) + 1
    x0, x1 = int(cols_any[0]), int(cols_any[-1]) + 1
    sub = map_np[y0:y1, x0:x1]
    mapped = mapped_f[y0:y1, x0:x1]
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    asx = np.where(mapped, xx + sub[..., 0], np.nan)  # absolute source col
    asy = np.where(mapped, yy + sub[..., 1], np.nan)  # absolute source row

    def col_constant(a):
        rng = np.nanmax(a, axis=0) - np.nanmin(a, axis=0)
        return np.nanmax(rng) < 1e-3 if np.isfinite(rng).any() else False

    def row_constant(a):
        return col_constant(a.T)

    if col_constant(asx):
        transposed = False            # line = output column -> source column
        line_coord, line_axis, pix_coord = asx, 0, asy
    elif row_constant(asy):
        transposed = True             # line = output row -> source row
        line_coord, line_axis, pix_coord = asy, 1, asx
    else:
        return None
    line_v = np.nanmax(line_coord, axis=line_axis)   # constant where mapped
    line_ok = np.isfinite(line_v)
    lv = np.where(line_ok, line_v, 0.0)
    line_src = np.where(line_ok, np.floor(lv), _UNMAPPED).astype(np.int32)
    line_frac = np.where(line_ok, lv - np.floor(lv), 0.0).astype(np.float32)
    pv = np.where(mapped, pix_coord, 0.0)
    pix_src = np.where(mapped, np.floor(pv), _UNMAPPED).astype(np.int32)
    pix_frac = np.where(mapped, pv - np.floor(pv), 0.0).astype(np.float32)
    return StripWarp((ho_f, wo_f), (y0, y1, x0, x1), transposed,
                     np.ascontiguousarray(pix_src), np.ascontiguousarray(pix_frac),
                     line_src, line_frac)
