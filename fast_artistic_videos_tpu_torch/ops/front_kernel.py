"""K3: the stylizer front's convs — counterpart of
``fast_artistic_videos_tpu/ops/front_pallas.py`` (``_kernel`` / ``same_conv``).

A zero-padded conv with the previous layer's instance-norm affine + ReLU
fused into its prologue (padding stays zero: it is applied after the
prologue) and instance-norm statistics of its output. Three launches compute
the demo/canonical net's layers 0-2 (``models/stylizer.py`` ``_front``):
c9s1-32 as (9, 9, 1, 4), then d64 and d128 as (3, 3, 2, 1).

The TPU computes these layers in a 16-phase space-to-depth layout with
top-margin bookkeeping (``out_row_shift``, ``chain_plan``) so its MXU sees
128-lane operands; the port works directly on the logical NHWC grid.
CUDA kernels, by ``_conv_in.conv_route``: in bfloat16 the three
layers run on the tensor cores (``csrc/front_tc.cu``, entry
``fav_front_tc``: an implicit GEMM with the stride-2 halo stored by column
parity and the 9x9 layer's K packed along the kernel row); in float32 on
the register-tiled CUDA-core kernel ``csrc/front_f32.cu`` (entry
``fav_front_f32``: compile-time taps, the stride-2 halo stored by column
parity, the 9x9 layer's weights streamed by kernel row). Other shapes take
the general template ``csrc/conv_in.cu``. ``KERNEL.routes`` counts the
launches of each.
"""

from __future__ import annotations

from ._build import Kernel
from ._conv_in import conv_in, conv_in_plain

KERNEL = Kernel("front_conv", "fast_artistic_videos_tpu_torch/csrc/front_f32.cu",
                "fast_artistic_videos_tpu/ops/front_pallas.py:44", "kernel.K3")


def same_conv(x, w, b, stride: int, pad: int, eff=None, relu: bool = False):
    """x (H, W, C) float32/bfloat16, w (Cout, C, kh, kw), b (Cout,),
    eff (2, C) float32. Returns (y, stats)."""
    return conv_in(KERNEL, x, w, b, stride=stride, pad=pad, eff=eff, relu=relu)


def same_conv_plain(x, w, b, stride: int, pad: int, eff=None, relu: bool = False):
    """The plain PyTorch version of :func:`same_conv`."""
    return conv_in_plain(x, w, b, stride=stride, pad=pad, eff=eff, relu=relu)
