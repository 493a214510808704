"""The port's conv routing rule and its C entry signatures, on the CPU.

``ops/_conv_in.tensor_core_route`` is a pure function of the dtype and the
conv's shape that names the tensor-core C entry a conv launches: in
bfloat16, 3x3 stride-1 convs with Cin % 64 == 0 and Cout % 128 == 0 (the
residual chain, K2, and the block convs, K4) run on ``csrc/conv_tc.cu``
(``fav_conv_tc``), the front's shapes (K3: 9x9 stride 1 with Cin <= 8 and
Cout % 32 == 0; 3x3 stride 2 with Cin % 32 == 0 and Cout % 64 == 0) on
``csrc/front_tc.cu`` (``fav_front_tc``); float32 and other shapes have no
tensor-core entry (None). ``ops/_conv_in.conv_route`` names every C entry:
the tensor-core one where there is one, ``fav_conv3x3_f32``
(``csrc/conv3x3_f32.cu``) for float32 3x3 stride-1 convs with pad 0 or 1,
Cin % 8 == 0 and Cout % 128 == 0 (every float32 K2 and K4 conv of the
stylizer), ``fav_front_f32`` (``csrc/front_f32.cu``) for the float32
front's shapes (9x9 stride 1 pad 4 with Cin <= 8 and Cout % 32 == 0; 3x3
stride 2 pad 1 with Cin % 8 == 0 and Cout % 64 == 0: every float32 K3
conv of the stylizer), and ``fav_conv_in`` (``csrc/conv_in.cu``) for the
rest. The C
entries are bound through ctypes with the
argument kinds of ``ops/_build.SIGNATURES``: a pointer declared there as an
int would be cut to 32 bits without any error, so every ``extern "C"``
entry of ``csrc/*.cu`` is checked against it here.
"""

import ctypes
import glob
import os
import re

import pytest
import torch

from fast_artistic_videos_tpu_torch.ops import _build, _conv_in

BF16, F32 = torch.bfloat16, torch.float32
TC, FRONT = "fav_conv_tc", "fav_front_tc"
F32_3X3, GENERAL = "fav_conv3x3_f32", "fav_conv_in"
FRONT_F32 = "fav_front_f32"


@pytest.mark.parametrize("dtype,k,stride,pad,cin,cout,want", [
    (BF16, 3, 1, 0, 128, 128, TC),        # K2: every conv of the R128 chain
    (BF16, 3, 1, 0, 128, 256, TC),
    (BF16, 3, 1, 1, 128, 128, TC),        # K4 SAME
    (BF16, 3, 1, 0, 256, 256, TC),        # K4 VALID, wider
    (BF16, 3, 1, 1, 64, 128, TC),         # one 64-channel chunk
    (F32, 3, 1, 0, 128, 128, None),       # float32 keeps the CUDA-core route
    (F32, 3, 1, 1, 256, 256, None),
    (BF16, 9, 1, 4, 7, 32, FRONT),        # K3 layer 0
    (BF16, 3, 2, 1, 32, 64, FRONT),       # K3 layer 1
    (BF16, 3, 2, 1, 64, 128, FRONT),      # K3 layer 2
    (BF16, 9, 1, 4, 3, 64, FRONT),        # the front's other widths
    (BF16, 3, 2, 1, 96, 64, FRONT),
    (F32, 9, 1, 4, 7, 32, None),          # the front in float32
    (F32, 3, 2, 1, 32, 64, None),
    (F32, 3, 2, 1, 64, 128, None),
    (BF16, 3, 2, 1, 20, 40, None),        # a narrow stride-2 conv
    (BF16, 9, 1, 4, 16, 32, None),        # 9x9 beyond one 8-channel group
    (BF16, 9, 1, 4, 7, 48, None),         # Cout not a multiple of 32
    (BF16, 3, 2, 0, 32, 64, None),        # stride 2 without the pad of 1
    (BF16, 5, 1, 2, 7, 32, None),         # another front kernel size
    (BF16, 3, 1, 0, 40, 48, None),        # narrow widths
    (BF16, 3, 1, 0, 96, 128, None),       # Cin not a multiple of 64
    (BF16, 3, 1, 0, 128, 64, None),       # Cout not a multiple of 128
    (BF16, 3, 1, 2, 128, 128, None),      # pad beyond the halo
    (torch.float16, 3, 1, 0, 128, 128, None),
])
def test_tensor_core_route_rule(dtype, k, stride, pad, cin, cout, want):
    assert _conv_in.tensor_core_route(dtype, k, k, stride, pad, cin, cout) == want


def test_tensor_core_route_covers_the_stylizer_widths():
    """The demo model's residual blocks are 128 -> 128: in bfloat16 every K2
    and K4 conv takes conv_tc.cu, and the front's three layers (K3) take
    front_tc.cu; in float32 none takes the tensor cores."""
    from fast_artistic_videos_tpu_torch.models import checkpoint

    spec = checkpoint.load_model("demo", "cpu")[0]
    blocks = [l for l in spec.layers if l.kind == "res_block"]
    assert blocks
    for l in blocks:
        d = l.out_channels
        assert _conv_in.tensor_core_route(BF16, 3, 3, 1, 0, d, d) == TC
        assert _conv_in.tensor_core_route(BF16, 3, 3, 1, 1, d, d) == TC
        assert _conv_in.tensor_core_route(F32, 3, 3, 1, 0, d, d) is None
    front = spec.layers[:3]
    assert [(l.ksize, l.stride, l.out_channels) for l in front] == [(9, 1, 32), (3, 2, 64),
                                                                      (3, 2, 128)]
    cin = spec.in_channels
    for l in front:
        shape = (l.ksize, l.ksize, l.stride, l.pad, cin, l.out_channels)
        assert _conv_in.tensor_core_route(BF16, *shape) == FRONT
        assert _conv_in.tensor_core_route(F32, *shape) is None
        cin = l.out_channels


@pytest.mark.parametrize("dtype,k,stride,pad,cin,cout,want", [
    (F32, 3, 1, 0, 128, 128, F32_3X3),    # K2: every conv of the R128 chain
    (F32, 3, 1, 1, 128, 128, F32_3X3),    # K4 SAME
    (F32, 3, 1, 0, 128, 256, F32_3X3),    # K4 VALID, two channel blocks
    (F32, 3, 1, 1, 256, 256, F32_3X3),
    (F32, 3, 1, 0, 8, 128, F32_3X3),      # one 8-channel chunk
    (F32, 3, 1, 0, 40, 128, F32_3X3),     # five chunks
    (F32, 9, 1, 4, 7, 32, FRONT_F32),     # K3 layer 0 in float32
    (F32, 3, 2, 1, 32, 64, FRONT_F32),    # K3 layers 1 and 2 (stride 2)
    (F32, 3, 2, 1, 64, 128, FRONT_F32),
    (F32, 9, 1, 4, 3, 64, FRONT_F32),     # the float32 front's other widths
    (F32, 9, 1, 4, 8, 96, FRONT_F32),
    (F32, 3, 2, 1, 8, 64, FRONT_F32),
    (F32, 3, 2, 1, 96, 128, FRONT_F32),
    (F32, 3, 2, 1, 128, 192, FRONT_F32),  # 64-channel blocks
    (F32, 9, 1, 4, 9, 32, GENERAL),       # 9x9 beyond one 8-channel chunk
    (F32, 9, 1, 4, 7, 48, GENERAL),       # Cout not a multiple of 32
    (F32, 9, 1, 3, 7, 32, GENERAL),       # 9x9 without the pad of 4
    (F32, 9, 2, 4, 7, 32, GENERAL),       # 9x9 at stride 2
    (F32, 3, 2, 1, 20, 40, GENERAL),      # a narrow stride-2 conv
    (F32, 3, 2, 1, 12, 64, GENERAL),      # Cin not a multiple of 8
    (F32, 3, 2, 1, 32, 96, GENERAL),      # Cout not a multiple of 64
    (F32, 3, 2, 0, 32, 64, GENERAL),      # stride 2 without the pad of 1
    (F32, 5, 2, 2, 32, 64, GENERAL),      # another front kernel size
    (F32, 3, 1, 0, 40, 48, GENERAL),      # narrow Cout
    (F32, 3, 1, 0, 12, 128, GENERAL),     # Cin not a multiple of 8
    (F32, 3, 1, 0, 128, 64, GENERAL),     # Cout not a multiple of 128
    (F32, 3, 1, 2, 128, 128, GENERAL),    # pad beyond the halo
    (F32, 5, 1, 2, 128, 128, GENERAL),    # another kernel size
    (BF16, 3, 1, 0, 128, 128, TC),        # bfloat16: as tensor_core_route says
    (BF16, 3, 1, 1, 256, 256, TC),
    (BF16, 9, 1, 4, 7, 32, FRONT),
    (BF16, 3, 2, 1, 64, 128, FRONT),
    (BF16, 3, 1, 0, 40, 48, GENERAL),
    (BF16, 3, 1, 0, 96, 128, GENERAL),
    (torch.float16, 3, 1, 0, 128, 128, GENERAL),
])
def test_conv_route_rule(dtype, k, stride, pad, cin, cout, want):
    assert _conv_in.conv_route(dtype, k, k, stride, pad, cin, cout) == want
    tc = _conv_in.tensor_core_route(dtype, k, k, stride, pad, cin, cout)
    assert want == tc if tc is not None else want in (F32_3X3, FRONT_F32, GENERAL)


def test_conv_route_covers_the_stylizer_widths():
    """Every float32 K2 and K4 conv of the demo model takes conv3x3_f32.cu,
    and every float32 front conv (K3) front_f32.cu."""
    from fast_artistic_videos_tpu_torch.models import checkpoint

    spec = checkpoint.load_model("demo", "cpu")[0]
    for l in spec.layers:
        if l.kind == "res_block":
            d = l.out_channels
            assert _conv_in.conv_route(F32, 3, 3, 1, 0, d, d) == F32_3X3      # K2
            assert _conv_in.conv_route(F32, 3, 3, 1, 1, d, d) == F32_3X3      # K4 SAME
    cin = spec.in_channels
    for l in spec.layers[:3]:
        shape = (l.ksize, l.ksize, l.stride, l.pad, cin, l.out_channels)
        assert _conv_in.conv_route(F32, *shape) == FRONT_F32
        cin = l.out_channels


def _c_entries():
    """{name: [kind, ...]} of every extern "C" function in csrc/*.cu, kind
    "p" for a pointer, "i" for an int and "f" for a float."""
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
                elif re.match(r"^(const\s+)?float\s+\w+$", arg):
                    kinds.append("f")
                else:
                    raise AssertionError(f"{m.group(1)}: unexpected argument {arg!r}")
            out[m.group(1)] = kinds
    return out


def test_every_c_entry_has_a_matching_signature():
    entries = _c_entries()
    assert {"fav_conv_tc", "fav_front_tc", "fav_conv_in", "fav_conv3x3_f32", "fav_front_f32",
            "fav_strip_warp", "fav_strip_warp_sum", "fav_warp_banded",
            "fav_warp_banded_vec", "fav_upconv_f32", "fav_correlation_f32"} <= set(entries)
    assert set(entries) == set(_build.SIGNATURES)
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for name, kinds in entries.items():
        bound = [kind.get(t, "?") for t in _build.SIGNATURES[name]]
        assert bound == kinds, name
        assert kinds[-1] == "p", f"{name}: the stream comes last"


def test_tc_weights_are_packed_once_per_version(monkeypatch):
    """The bfloat16 3x3 route's (3, 3, Cout, Cin) weights are built once per
    parameter tensor and kept on it: a second launch reuses them, and an
    in-place change of the weights (their version) rebuilds them."""
    builds, pack = [], _conv_in.pack_tc_weights

    def counting(w):
        builds.append(w._version)
        return pack(w)
    monkeypatch.setattr(_conv_in, "pack_tc_weights", counting)
    w = torch.randn(128, 64, 3, 3, generator=torch.Generator().manual_seed(0))
    p1 = _conv_in._tc_weights(w)
    assert _conv_in._tc_weights(w) is p1 and len(builds) == 1
    assert p1.dtype == BF16 and p1.shape == (3, 3, 128, 64)
    assert torch.equal(p1, w.to(BF16).permute(2, 3, 0, 1))
    with torch.no_grad():
        w.mul_(2.0)
    p2 = _conv_in._tc_weights(w)
    assert len(builds) == 2 and p2 is not p1
    assert torch.equal(p2, w.to(BF16).permute(2, 3, 0, 1))
    assert _conv_in._tc_weights(w) is p2 and len(builds) == 2
    # another parameter tensor has a pack of its own
    assert torch.equal(_conv_in._tc_weights(w.clone()), p2) and len(builds) == 3


def test_rounded_bias_is_built_once_per_version_and_dtype():
    """The float32 bias rounded to the storage dtype is kept on the tensor per
    dtype, rebuilt after an in-place change, and equals the rounding it
    replaces."""
    b = torch.randn(128, generator=torch.Generator().manual_seed(1)) * 0.1
    r16 = _conv_in.rounded_bias(b, BF16)
    r32 = _conv_in.rounded_bias(b, F32)
    assert r16.dtype == r32.dtype == F32 and r16.is_contiguous()
    assert torch.equal(r16, b.to(BF16).float()) and torch.equal(r32, b)
    assert not torch.equal(r16, r32)
    assert _conv_in.rounded_bias(b, BF16) is r16 and _conv_in.rounded_bias(b, F32) is r32
    with torch.no_grad():
        b.add_(1.0)
    n16 = _conv_in.rounded_bias(b, BF16)
    assert n16 is not r16 and torch.equal(n16, b.to(BF16).float())
    assert torch.equal(_conv_in.rounded_bias(b, F32), b)


def test_kernel_counts_routes_and_resets():
    k = _build.Kernel("k", "src", "replaces", "kernel.K0")
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
