"""K6, the folded upsample conv (``ops/upconv_kernel.py``,
``csrc/upconv_f32.cu``), on the CPU: its plain version against the
layer-by-layer tail it replaces, its folded weights against the JAX
package's ``_folded_upsample_conv``, the packed layout against the order the
kernel walks, the layers the stylizer's plan folds, and the stylizer's
kernel path against its plain path on the canonical net. The kernel's own arithmetic is held
against the plain version on the card (``tests/test_torch_kernels_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu_torch.models import arch_dsl, stylizer
from fast_artistic_videos_tpu_torch.ops import upconv_kernel

# the canonical tail's two folds: (k, Cin, Cout, the conv's layer index)
TAIL = [(3, 128, 64, 9), (9, 64, 3, 11)]
SPEC = arch_dsl.parse_arch("canonical")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the suite runs several workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tail_params(k, cin, cout, seed):
    g = torch.Generator().manual_seed(seed)
    conv = {"w": torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5,
            "b": torch.randn(cout, generator=g) * 0.1}
    norm = {"scale": torch.rand(cin, generator=g) + 0.5, "bias": torch.randn(cin, generator=g)}
    out_norm = {"scale": torch.rand(cout, generator=g) + 0.5,
                "bias": torch.randn(cout, generator=g)}
    return conv, norm, out_norm


@pytest.mark.parametrize("k,cin,cout,layer", TAIL)
@pytest.mark.parametrize("n,h,w", [(1, 5, 7), (1, 6, 8), (2, 7, 6)])
def test_folded_tail_matches_the_layer_by_layer_tail(k, cin, cout, layer, n, h, w):
    """``stylizer.upsample_conv`` (the upsample's instance norm taken at low
    resolution, the plain version of K6) against upsample -> instance norm
    -> ReLU -> zero-pad conv -> (instance norm -> ReLU, or tanh * 150) in
    float64, to 1e-5 of the output's scale."""
    conv, norm, out_norm = _tail_params(k, cin, cout, seed=layer + h)
    params = {f"layer{layer - 1:02d}_norm": norm, f"layer{layer:02d}": conv,
              f"layer{layer:02d}_norm": out_norm}
    x = torch.randn(n, h, w, cin, generator=torch.Generator().manual_seed(w)) * 3 + 1
    got = stylizer.upsample_conv(params, SPEC, layer - 1, x)

    d = lambda t: t.double()                                   # noqa: E731
    up = stylizer.upsample_nearest(d(x), 2)
    a = torch.relu(stylizer.instance_norm(up, d(norm["scale"]), d(norm["bias"])))
    want = stylizer.conv2d(a, d(conv["w"]), d(conv["b"]), 1, (k - 1) // 2)
    if layer == len(SPEC.layers) - 1:
        want = torch.tanh(want) * SPEC.tanh_constant
    else:
        want = torch.relu(stylizer.instance_norm(want, d(out_norm["scale"]),
                                                 d(out_norm["bias"])))
    assert got.dtype == torch.float32 and got.shape == want.shape == (n, 2 * h, 2 * w, cout)
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("k,cin,cout", [(3, 16, 32), (9, 8, 3)])
@pytest.mark.parametrize("h,w", [(5, 7), (6, 8)])
def test_folded_weights_match_the_jax_fold(k, cin, cout, h, w):
    """The plain version without a prologue is the JAX package's
    ``_folded_upsample_conv`` (its 9x9 fold at even sizes takes a second
    space-to-depth level, at odd sizes not) on the same numpy inputs."""
    rng = np.random.default_rng(k * 100 + h)
    x = rng.standard_normal((1, h, w, cin)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, cin, cout)) / k).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jsty._folded_upsample_conv(jnp.asarray(x), jnp.asarray(w_hwio),
                                                 jnp.asarray(b), k, (k - 1) // 2))
    got = upconv_kernel.upconv_plain(torch.from_numpy(x),
                                     torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()),
                                     torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (1, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("k,q", [(3, 16), (9, 100), (5, 36), (7, 64)])
def test_packed_weights_follow_the_kernels_order(k, q):
    """``pack_upconv_weights`` row q of input channel c is the folded weight
    of the q-th (window row, window column, phase row, phase column) in the
    kernel's walk (row-major, unused combinations skipped); each phase takes
    taps x taps of the window, and every tap of w lands in exactly one
    folded weight of each phase."""
    g = torch.Generator().manual_seed(k)
    w = torch.randn(5, 4, k, k, generator=g)
    first, span, taps = upconv_kernel.fold_window(k)
    order = upconv_kernel.tap_phases(k)
    assert len(order) == q == 4 * taps * taps
    assert order == sorted(order)
    packed = upconv_kernel.pack_upconv_weights(w)
    assert packed.shape == (4, q, 5) and packed.is_contiguous()
    pad = (k - 1) // 2
    for i, (du, dv, p, r) in enumerate(order):
        want = sum(w[:, :, u, v] for u in range(k) for v in range(k)
                   if (p + u - pad) // 2 - first == du and (r + v - pad) // 2 - first == dv)
        assert (packed[:, i].t() - want).abs().max().item() <= 1e-6
    folded = upconv_kernel.fold_weights(w)
    assert (folded.sum(dim=(4, 5)) - w.sum(dim=(2, 3))).abs().max().item() <= 1e-5


# (arch, parse_arch keywords, dtype, fused, the upsample layer the case asks about)
ROUTE_CASES = {
    "float32 U2 -> 3x3 128 -> 64": ("canonical", {}, torch.float32, True, 8),
    "float32 U2 -> 9x9 64 -> 3": ("canonical", {}, torch.float32, True, 10),
    "bfloat16": ("canonical", {}, torch.bfloat16, True, 8),
    "fused=False": ("canonical", {}, torch.float32, False, 8),
    "u64 (learned upsample)": ("train-default", {}, torch.float32, True, 8),
    "reflect-padded conv": ("canonical", {"padding_type": "reflect"}, torch.float32, True, 8),
    "U4": ("c9s1-32,d64,d128,R128,U4,c3s1-64,c9s1-3", {}, torch.float32, True, 4),
    "uncovered widths": ("c9s1-32,d64,d12,U2,c3s1-64,U2,c9s1-3", {}, torch.float32, True, 3),
    "stride-2 conv": ("c9s1-32,d64,d128,U2,d64,U2,c9s1-3", {}, torch.float32, True, 3),
}


@pytest.mark.parametrize("case,want", [
    ("float32 U2 -> 3x3 128 -> 64", upconv_kernel.ENTRY),
    ("float32 U2 -> 9x9 64 -> 3", upconv_kernel.ENTRY),
    ("bfloat16", None),
    ("fused=False", None),
    ("u64 (learned upsample)", None),
    ("reflect-padded conv", None),
    ("U4", None),
    ("uncovered widths", None),
    ("stride-2 conv", None),
])
def test_upconv_route(case, want):
    """Whether ``stylizer.layer_plan`` folds the layer of the case and the
    conv after it into one K6 launch (``fav_upconv_f32``): only a nearest 2x
    upsample before a stride-1 zero-padded conv of a covered shape, in
    float32, under ``fused``; the fold that ends the net carries its tanh,
    so no "tanh" step follows it."""
    arch, kw, dtype, fused, up = ROUTE_CASES[case]
    spec = arch_dsl.parse_arch(arch, **kw)
    plan = stylizer.layer_plan(spec, (1, 1080, 1920, 7), dtype, fused)
    got = upconv_kernel.ENTRY if ("K6", (up, up + 1)) in plan else None
    assert got == want
    last = len(spec.layers) - 1
    assert (plan[-1] == ("K6", (last - 1, last))) != (plan[-1] == ("tanh", ()))


@pytest.mark.parametrize("n", [1, 2])
def test_canonical_fused_matches_plain(n):
    """The canonical net in float32 on the CPU with ``fused=True`` (K3, K2 or
    K4, and K6 as their plain versions) against ``fused=False``; resumed at
    layer 8 (the feature-reuse path) and stopped after the fold's conv, the
    tail gives the same as the plain path."""
    params = stylizer.init_params(torch.Generator().manual_seed(0), SPEC, device="cpu")
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 44, 52, 7, generator=g) * 60
    feats = torch.randn(n, 6, 7, 128, generator=g) * 3
    with torch.no_grad():
        got = stylizer.apply(params, SPEC, x, fused=True)
        want = stylizer.apply(params, SPEC, x, fused=False)
        assert got.shape == (n, 44, 52, 3)
        assert (got - want).abs().max().item() / 255.0 <= 1e-5
        for stop, shape in ((9, (n, 12, 14, 64)), (None, (n, 24, 28, 3))):
            a = stylizer.apply(params, SPEC, feats, fused=True, start_at=8, stop_after=stop)
            b = stylizer.apply(params, SPEC, feats, fused=False, start_at=8, stop_after=stop)
            assert a.shape == b.shape == shape
            assert (a - b).abs().max().item() / 255.0 <= 1e-5


@pytest.mark.parametrize("constant", [0.0, -2.5])
def test_last_layer_applies_tanh_whatever_the_constants_sign(constant):
    """The net's tanh is applied for every ``tanh_constant`` a checkpoint or a
    t7 file may carry, zero and negative ones too: the folded tail (K6's
    plain version) against the plain path, and ``upconv`` tells the kernel
    to apply it by a flag of its own, not by the constant's sign."""
    spec = arch_dsl.parse_arch("canonical", tanh_constant=constant)
    params = stylizer.init_params(torch.Generator().manual_seed(4), spec, device="cpu")
    x = torch.randn(1, 6, 7, 128, generator=torch.Generator().manual_seed(5)) * 3
    with torch.no_grad():
        got = stylizer.apply(params, spec, x, fused=True, start_at=8)
        want = stylizer.apply(params, spec, x, fused=False, start_at=8)
    assert (got - want).abs().max().item() <= 1e-5 * max(abs(constant), 1.0)
    if constant == 0.0:
        assert not got.any()
    assert upconv_kernel.tanh_args(constant) == (1, constant)
    assert upconv_kernel.tanh_args(None) == (0, 0.0)


def test_cpu_tensors_take_the_plain_version_and_refuse_gradients():
    """On the CPU ``upconv`` is the plain version and counts no launch; a
    weight that requires grad under grad mode raises (the kernel has no
    backward)."""
    conv, _, _ = _tail_params(3, 16, 32, seed=1)
    x = torch.randn(1, 5, 6, 16, generator=torch.Generator().manual_seed(2))
    before = upconv_kernel.KERNEL.launches
    got = upconv_kernel.upconv(x, conv["w"], conv["b"], relu=True, stats=True)
    want = upconv_kernel.upconv_plain(x, conv["w"], conv["b"], relu=True, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert upconv_kernel.KERNEL.launches == before
    w = conv["w"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        upconv_kernel.upconv(x, w, conv["b"])
