"""K7: FlowNetC's correlation layer — wrapper of ``csrc/correlation_f32.cu``
and its plain PyTorch version.

K7 replaces no Pallas kernel: no estimator of the JAX package computes a
wide correlation (PWC-lite's radius-3 cost volume stays plain). It is
FlowNet 2.0's correlation (``flow/flownet2.py``; flownet2-pytorch's
``Correlation(pad_size=20, kernel_size=1, max_displacement=20, stride1=1,
stride2=2)``) followed by its LeakyReLU:

    out[n, 21 i + j, y, x] = leaky_relu_0.1( sum_c a[n, c, y, x]
                                 * b[(n + b_shift) % N, c, y + 2i - 20, x + 2j - 20] / C )

for i, j < 21, b reading zero outside the map. a and b are (N, C, H, W)
NCHW, as the convs produce them; a batch shift lets one launch correlate
both directions of a pair held as one batch ([a; b] against [b; a]). The
result may be written into a channel slice of a larger NCHW float32 tensor
(``out``: FlowNetC's conv3_1 input, [redir, corr]), so nothing is copied
around the kernel. bfloat16 maps are upcast: the kernel has one dtype.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (a loop over the 441 shifts). Each launch adds one to
``KERNEL.launches`` and to ``KERNEL.routes[ENTRY]``; a call on the card is
the span ``kernel.K7``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiling
from ._build import Kernel, no_grad_inputs, ptr

KERNEL = Kernel("correlation", "fast_artistic_videos_tpu_torch/csrc/correlation_f32.cu",
                "none (FlowNetC's correlation; no Pallas kernel computes one)", "kernel.K7")
ENTRY = "fav_correlation_f32"
MAX_DISPLACEMENT = 20
DISPLACEMENT_STRIDE = 2
GRID = 2 * MAX_DISPLACEMENT // DISPLACEMENT_STRIDE + 1      # 21 displacements an axis
CHANNELS = GRID * GRID                                      # 441


def _out_view(a, out):
    n, _, h, w = a.shape
    if out is None:
        return torch.empty((n, CHANNELS, h, w), dtype=torch.float32, device=a.device)
    if tuple(out.shape) != (n, CHANNELS, h, w) or out.dtype != torch.float32:
        raise ValueError(f"{KERNEL.name}: out must be float32 {(n, CHANNELS, h, w)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def correlation_plain(a, b, out=None, b_shift: int = 0):
    """Plain version, in float32: one product and channel sum a shift."""
    res = _out_view(a, out)
    c, h, w = a.shape[1:]
    af = a.float()
    bf = torch.roll(b.float(), -b_shift, 0) if b_shift else b.float()
    d = MAX_DISPLACEMENT
    bp = F.pad(bf, (d, d, d, d))
    for i in range(GRID):
        for j in range(GRID):
            dy, dx = DISPLACEMENT_STRIDE * i, DISPLACEMENT_STRIDE * j
            res[:, i * GRID + j] = (af * bp[:, :, dy:dy + h, dx:dx + w]).sum(dim=1) / c
    res.copy_(F.leaky_relu(res, 0.1))
    return res


def correlation(a, b, out=None, b_shift: int = 0):
    """K7 on a CUDA tensor, the plain version on a CPU tensor. a, b (N, C,
    H, W) float32 or bfloat16 (upcast); out: None or a float32 (N, 441, H,
    W) tensor, contiguous within each image (a channel slice of a
    contiguous NCHW tensor). Returns the result (``out`` where given).
    Raises on any device when asked to carry a gradient."""
    no_grad_inputs(KERNEL.name, a, b)
    if a.ndim != 4 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"{KERNEL.name}: a and b must be (N, C, H, W) of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if not 0 <= b_shift < a.shape[0]:
        raise ValueError(f"{KERNEL.name}: b_shift {b_shift} outside the batch of {a.shape[0]}")
    if a.device.type == "cpu":
        return correlation_plain(a, b, out, b_shift)
    with profiling.span(KERNEL.span):
        return _correlation_card(a, b, out, b_shift)


def _correlation_card(a, b, out, b_shift: int):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{KERNEL.name}: unsupported devices {a.device}, {b.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"{KERNEL.name}: unsupported dtypes {a.dtype}, {b.dtype}")
    af = a.float().contiguous()
    bf = af if b is a else b.float().contiguous()
    res = _out_view(a, out)
    n, c, h, w = a.shape
    if res.device != a.device or res.stride()[1:] != (h * w, w, 1):
        raise ValueError(f"{KERNEL.name}: out must lie on {a.device}, each image contiguous")
    if max(af.numel(), res.stride(0) * n) >= 2 ** 31:
        raise ValueError(f"{KERNEL.name}: more than 2^31 elements")
    KERNEL.call(ENTRY, a.device, ptr(af), ptr(bf), ptr(res), n, c, h, w, res.stride(0), b_shift)
    return res
