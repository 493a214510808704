"""K2: the residual chain's conv — counterpart of
``fast_artistic_videos_tpu/ops/rblock_pallas.py`` (``_kernel`` / ``chain_conv``).

A VALID 3x3 stride-1 conv with the fused prologue of the next residual
block (previous conv's instance-norm affine, ReLU, the residual add
``skip[+2, +2]``, optional emission of the materialized block input) and
instance-norm statistics of its output, so a residual block is two launches
(``models/stylizer.py`` ``_fused_res_chain`` drives them).

The TPU kernel runs the whole chain on one constant, aligned physical shape
and masks its statistics to the valid extent; that is a TPU alignment
workaround. Here every conv runs on its logical (shrinking) shape:
x (H, W, C) -> y (H - 2, W - 2, Cout), and the statistics cover all of y.
CUDA kernels, by ``_conv_in.conv_route`` of the dtype and widths, each
with (kh, kw, stride, pad) = (3, 3, 1, 0): bfloat16 with C % 64 == 0 and
Cout % 128 == 0 (every conv of the R128 chain) runs on the tensor cores
(``csrc/conv_tc.cu``), float32 with C % 8 == 0 and Cout % 128 == 0 on the
register-tiled CUDA-core kernel (``csrc/conv3x3_f32.cu``), other widths on
the general CUDA-core template (``csrc/conv_in.cu``). ``KERNEL.routes``
counts the launches of each.
"""

from __future__ import annotations

from ._build import Kernel
from ._conv_in import conv_in, conv_in_plain

KERNEL = Kernel("res_chain_conv", "fast_artistic_videos_tpu_torch/csrc/conv3x3_f32.cu",
                "fast_artistic_videos_tpu/ops/rblock_pallas.py:69", "kernel.K2")


def chain_conv(x, w, b, eff=None, pre_relu: bool = False, skip=None,
               emit_input: bool = False):
    """x (H, W, C) float32/bfloat16, w (Cout, C, 3, 3), b (Cout,),
    eff (2, C) float32, skip (H + 4, W + 4, C). Returns (y, stats) or
    (y, stats, a) with emit_input; y is (H - 2, W - 2, Cout)."""
    return conv_in(KERNEL, x, w, b, stride=1, pad=0, eff=eff, relu=pre_relu,
                   skip=skip, emit_input=emit_input)


def chain_conv_plain(x, w, b, eff=None, pre_relu: bool = False, skip=None,
                     emit_input: bool = False):
    """The plain PyTorch version of :func:`chain_conv`."""
    return conv_in_plain(x, w, b, stride=1, pad=0, eff=eff, relu=pre_relu,
                         skip=skip, emit_input=emit_input)
