"""The port's conv routing rule and its C entry signatures, on the CPU.

``ops/_conv_in.tensor_core_route`` is a pure function of the dtype and the
conv's shape: bfloat16 3x3 stride-1 convs with Cin % 64 == 0 and Cout % 128
== 0 (the residual chain, K2, and the block convs, K4) run on the tensor
cores (``csrc/conv_tc.cu``); float32, the front's convs (K3) and narrower
widths stay on ``csrc/conv_in.cu``. The C entries are bound through ctypes
with the argument kinds of ``ops/_build.SIGNATURES``: a pointer declared
there as an int would be cut to 32 bits without any error, so every
``extern "C"`` entry of ``csrc/*.cu`` is checked against it here.
"""

import ctypes
import glob
import os
import re

import pytest
import torch

from fast_artistic_videos_tpu_torch.ops import _build, _conv_in

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,k,stride,pad,cin,cout,want", [
    (BF16, 3, 1, 0, 128, 128, True),      # K2: every conv of the R128 chain
    (BF16, 3, 1, 0, 128, 256, True),
    (BF16, 3, 1, 1, 128, 128, True),      # K4 SAME
    (BF16, 3, 1, 0, 256, 256, True),      # K4 VALID, wider
    (BF16, 3, 1, 1, 64, 128, True),       # one 64-channel chunk
    (F32, 3, 1, 0, 128, 128, False),      # float32 keeps the CUDA-core route
    (F32, 3, 1, 1, 256, 256, False),
    (BF16, 9, 1, 4, 7, 32, False),        # K3 layer 0
    (BF16, 3, 2, 1, 32, 64, False),       # K3 layer 1
    (BF16, 3, 2, 1, 64, 128, False),      # K3 layer 2: stride 2
    (BF16, 3, 1, 0, 40, 48, False),       # narrow widths
    (BF16, 3, 1, 0, 96, 128, False),      # Cin not a multiple of 64
    (BF16, 3, 1, 0, 128, 64, False),      # Cout not a multiple of 128
    (BF16, 3, 1, 2, 128, 128, False),     # pad beyond the halo
    (torch.float16, 3, 1, 0, 128, 128, False),
])
def test_tensor_core_route_rule(dtype, k, stride, pad, cin, cout, want):
    assert _conv_in.tensor_core_route(dtype, k, k, stride, pad, cin, cout) is want


def test_tensor_core_route_covers_the_stylizer_widths():
    """The demo model's residual blocks are 128 -> 128: in bfloat16 every K2
    and K4 conv takes the tensor cores, and no K3 layer does."""
    from fast_artistic_videos_tpu_torch.models import checkpoint

    spec = checkpoint.load_model("demo", "cpu")[0]
    blocks = [l for l in spec.layers if l.kind == "res_block"]
    assert blocks
    for l in blocks:
        d = l.out_channels
        assert _conv_in.tensor_core_route(BF16, 3, 3, 1, 0, d, d)
        assert _conv_in.tensor_core_route(BF16, 3, 3, 1, 1, d, d)
        assert not _conv_in.tensor_core_route(F32, 3, 3, 1, 0, d, d)
    front = spec.layers[:3]
    cin = spec.in_channels
    for l in front:
        assert not _conv_in.tensor_core_route(BF16, l.ksize, l.ksize, l.stride, l.pad, cin,
                                              l.out_channels)
        cin = l.out_channels


def _c_entries():
    """{name: [kind, ...]} of every extern "C" function in csrc/*.cu, kind
    "p" for a pointer and "i" for an int."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src):
            kinds = []
            for arg in m.group(2).split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append("p")
                elif re.match(r"^(const\s+)?int\s+\w+$", arg):
                    kinds.append("i")
                else:
                    raise AssertionError(f"{m.group(1)}: unexpected argument {arg!r}")
            out[m.group(1)] = kinds
    return out


def test_every_c_entry_has_a_matching_signature():
    entries = _c_entries()
    assert "fav_conv_tc" in entries and "fav_conv_in" in entries
    assert set(entries) == set(_build.SIGNATURES)
    for name, kinds in entries.items():
        bound = ["p" if t is ctypes.c_void_p else "i" if t is ctypes.c_int else "?"
                 for t in _build.SIGNATURES[name]]
        assert bound == kinds, name
        assert kinds[-1] == "p", f"{name}: the stream comes last"


def test_kernel_counts_routes_and_resets():
    k = _build.Kernel("k", "src", "replaces")
    k.launches, k.routes = 3, {"fav_conv_tc": 2, "fav_conv_in": 1}
    k.reset()
    assert k.launches == 0 and k.routes == {}


@pytest.mark.parametrize("emit", [False, True])
def test_cpu_tensors_take_the_plain_version(emit):
    """On the CPU the wrapper runs the plain version whatever the route
    rule says: the same numbers as conv_in_plain, no launch counted."""
    from fast_artistic_videos_tpu_torch.ops import conv_kernel, rblock_kernel

    g = torch.Generator().manual_seed(0)
    x = torch.randn(9, 11, 128, generator=g).to(BF16)
    w = torch.randn(128, 128, 3, 3, generator=g) / 34
    b = torch.randn(128, generator=g) * 0.1
    eff = torch.stack([torch.rand(128, generator=g) + 0.5, torch.randn(128, generator=g)])
    before = (rblock_kernel.KERNEL.launches, conv_kernel.KERNEL.launches)
    got = rblock_kernel.chain_conv(x, w, b, eff=eff, pre_relu=True, emit_input=emit)
    want = rblock_kernel.chain_conv_plain(x, w, b, eff=eff, pre_relu=True, emit_input=emit)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)
    y4 = conv_kernel.conv3x3(x[None], w, b, relu=True)
    assert torch.equal(y4, conv_kernel.conv3x3_plain(x[None], w, b, True, 1))
    assert (rblock_kernel.KERNEL.launches, conv_kernel.KERNEL.launches) == before
