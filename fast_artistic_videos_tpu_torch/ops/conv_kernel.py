"""K4: the 3x3 stride-1 block conv — wrapper of ``csrc/conv_tc.cu``
(bfloat16) and ``csrc/conv3x3_f32.cu`` (float32), and its plain PyTorch
version.

Replaces ``fast_artistic_videos_tpu/ops/conv_pallas.py`` ``_conv3x3_kernel``
(``conv3x3_pallas`` / ``conv3x3_pallas_valid``): the residual- and
conv-block convs that the fused chain (K2) does not take, i.e. every block
conv of a batch larger than one (the ``--create_inconsistent
--inconsistent_batch N`` throughput mode) and the blocks of zero, reflect or
replicate padding.

    y = [relu] ( conv(x, w) + b )          (f32 accumulate, one rounding)

x is (N, H, W, C) NHWC in float32 or bfloat16, weights OIHW (the port's
parameter layout) cast to x's dtype, as the Pallas kernel casts them. The
whole batch is one launch, as the JAX package's ``vmap`` over one
``pallas_call`` is one kernel. The route is ``_conv_in.conv_route`` of
the dtype and widths: bfloat16 with Cin % 64 == 0 and Cout % 128 == 0
(every K4 shape of the stylizer) runs on the tensor cores (``conv_tc.cu``),
float32 with Cin % 8 == 0 and Cout % 128 == 0 on the register-tiled
CUDA-core kernel (``conv3x3_f32.cu``); other widths, outside K4's contract
(``conv_pallas`` takes multiples of 128), raise, as does a failed launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiling
from ._build import Kernel, no_grad_inputs
from ._conv_in import CONV3X3_ENTRIES, conv_route, launch_3x3, rounded_bias

KERNEL = Kernel("conv3x3", "fast_artistic_videos_tpu_torch/csrc/conv3x3_f32.cu",
                "fast_artistic_videos_tpu/ops/conv_pallas.py:40", "kernel.K4")


def conv3x3_plain(x, w, b, relu: bool = False, pad: int = 1):
    """Plain version: F.conv2d in x's dtype with the bias inside the conv
    (one rounding to the storage dtype, as in the kernel), then the
    optional ReLU. x (N, H, W, C) -> (N, H + 2 pad - 2, W + 2 pad - 2, Cout)."""
    dtype = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(dtype), b.to(dtype), 1, pad)
    y = y.permute(0, 2, 3, 1)
    return (torch.relu(y) if relu else y).contiguous()


def _launch(x, w, b, relu: bool, pad: int):
    no_grad_inputs("conv3x3", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu, pad)
    with profiling.span(KERNEL.span):
        return _launch_card(x, w, b, relu, pad)


def _launch_card(x, w, b, relu: bool, pad: int):
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3: unsupported dtype {dtype}")
    if x.ndim != 4 or w.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"conv3x3: x must be contiguous (N, H, W, C), w OIHW; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    n, hin, win, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape[1:]) != (cin, 3, 3) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3: weights {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"are not a 3x3 conv of {cin} input channels")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3: operands on different devices")
    hout, wout = hin + 2 * pad - 2, win + 2 * pad - 2
    if hout < 1 or wout < 1:
        raise ValueError(f"conv3x3: empty output for input {(hin, win)}")
    bt = rounded_bias(b, dtype)                                 # rounded like x
    y = torch.empty((n, hout, wout, cout), dtype=dtype, device=x.device)
    if not y.numel():
        return y
    route = conv_route(dtype, 3, 3, 1, pad, cin, cout)
    if route not in CONV3X3_ENTRIES:
        raise ValueError(f"conv3x3: no kernel for {dtype} {cin} -> {cout} (bfloat16 needs "
                         f"Cin % 64 == 0, float32 Cin % 8 == 0, both Cout % 128 == 0; "
                         f"conv_pallas takes multiples of 128)")
    launch_3x3(KERNEL, route, x, w, bt, y, pad=pad, out_relu=relu)
    return y


def conv3x3(x, w, b, relu: bool = False):
    """K4, the zero-pad-1 (SAME) form: (N, H, W, C) -> (N, H, W, Cout). The
    zero border is read through the kernel's halo loads (no padded copy). A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    return _launch(x, w, b, relu, 1)


def conv3x3_valid(xp, w, b, relu: bool = False):
    """K4, the VALID form on a pre-padded input (the reflect and replicate
    blocks pad it themselves; the none and reflect-start blocks shrink):
    (N, H + 2, W + 2, C) -> (N, H, W, Cout)."""
    return _launch(xp, w, b, relu, 0)
