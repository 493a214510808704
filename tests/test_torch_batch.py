"""The batched 2D path of the port against the JAX package, on the CPU:
K4's plain version (``ops.conv_kernel``) against the JAX Pallas kernel
(``ops.conv_pallas``, interpreted on the CPU), the stylizer with the block
convs routed to K4 (``apply(fused=True)``) against the JAX
``apply(pallas_conv=True)``, ``StylizerEngine.stylize_batch`` on frames of
different sizes, and the port CLI's ``--create_inconsistent
--inconsistent_batch 2`` against the JAX CLI's output in
``tests/fixtures/torch_parity_batch.npz``. Inputs are made with numpy from
a seed; float32 agrees within 1e-4 (convs) / 1e-3 of the [0, 255] VGG range
after /255 (stylizer), bfloat16 within 1e-2 relative L2."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.ops import conv_pallas
from fast_artistic_videos_tpu.video import engine as jeng
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import conv_kernel
from fast_artistic_videos_tpu_torch.video import engine as teng
from tests.test_torch_cli import _mean_abs, _read, _write_frames
from tests.test_torch_stylizer import jax_apply, numpy_params, parse_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parity_batch.npz")


@pytest.fixture(scope="module")
def batch_fixture():
    with np.load(BATCH_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def port_cli_case(fixture, name, tmp_path, *extra):
    """Run the port CLI on the fixture's frames with the case's flags (and
    `extra`); returns (port uint8 frames, JAX uint8 frames)."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video as tcli

    want = fixture[f"outputs_{name}"]
    n = len(want)
    pattern = _write_frames(fixture["frames"][:n], str(tmp_path))
    prefix = os.path.join(tmp_path, "out", "o")
    tcli.main(["--input_pattern", pattern, "--model_vid", "demo", "--flow_model", "bundled",
               "--flow_scale", "0.5", "--output_prefix", prefix, "--num_frames", str(n),
               "--device", "cpu", *[str(a) for a in fixture[f"args_{name}"]], *extra])
    return _read(prefix, range(1, n + 1)), want


# ---------------------------------------------------------------------------
# K4: the plain version against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,cout,relu,valid,dtype", [
    (1, 128, 128, False, False, "float32"),
    (2, 128, 256, True, True, "float32"),
    (2, 256, 128, False, True, "float32"),
    (1, 256, 256, True, False, "float32"),
    (2, 128, 128, True, False, "bfloat16"),
])
def test_conv3x3_plain_matches_pallas(n, c, cout, relu, valid, dtype):
    rng = np.random.default_rng(n * 1000 + c + cout + relu)
    h, w = 9, 13
    x = rng.standard_normal((n, h + 2 * valid, w + 2 * valid, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jfn = conv_pallas.conv3x3_pallas_valid if valid else conv_pallas.conv3x3_pallas
    want = np.asarray(jfn(jnp.asarray(x, jdt), jnp.asarray(wt), jnp.asarray(b), relu=relu),
                      np.float32)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy())               # OIHW
    tfn = conv_kernel.conv3x3_valid if valid else conv_kernel.conv3x3
    got = tfn(tx, tw, torch.from_numpy(b), relu)
    assert got.dtype == tdt and tuple(got.shape) == (n, h, w, cout)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    if relu:
        assert got.min() >= 0.0


# ---------------------------------------------------------------------------
# the stylizer with K4's plain version in the block convs
# ---------------------------------------------------------------------------

def _count_k4(monkeypatch):
    """Count the calls of K4's plain version (what a CPU tensor runs)."""
    calls = []
    plain = conv_kernel.conv3x3_plain

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return plain(*a, **k)
    monkeypatch.setattr(conv_kernel, "conv3x3_plain", counted)
    return calls


def _stylize_both(spec, tspec, pj, x):
    want = np.asarray(jax_apply(pj, spec, x, pallas_conv=True), np.float32)
    pt = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    got = tsty.apply(pt, tspec, torch.from_numpy(x), fused=True).numpy()
    return got, want


def test_canonical_batch2_pallas_conv(monkeypatch):
    """The canonical arch at batch 2: its five R128 blocks (reflect-start,
    VALID convs) go through K4, two calls per block, and the whole net
    agrees with the JAX apply(pallas_conv=True)."""
    spec, tspec = parse_both("canonical", in_channels=7)
    pj = numpy_params(spec, 21)
    x = (np.random.default_rng(21).standard_normal((2, 44, 48, 7)) * 60).astype(np.float32)
    calls = _count_k4(monkeypatch)
    got, want = _stylize_both(spec, tspec, pj, x)
    assert len(calls) == 10 and all(s[0] == 2 for s in calls)
    assert got.shape == want.shape == (2, 44, 48, 3)
    assert np.abs(got - want).max() / 255.0 < 1e-3


@pytest.mark.parametrize("padding", ["zero", "reflect", "replicate"])
def test_block_padding_pallas_conv(monkeypatch, padding):
    """Blocks of zero (SAME form, pad through the halo), reflect and
    replicate padding (VALID form on the block's own padded input) at
    width 128; a residual block and a conv block."""
    spec, tspec = parse_both("c3s1-128,R128,C128,c3s1-3", in_channels=7,
                             padding_type=padding)
    pj = numpy_params(spec, 22)
    x = (np.random.default_rng(22).standard_normal((2, 10, 14, 7)) * 60).astype(np.float32)
    calls = _count_k4(monkeypatch)
    got, want = _stylize_both(spec, tspec, pj, x)
    assert len(calls) == 4
    assert got.shape == want.shape
    assert np.abs(got - want).max() / 255.0 < 1e-3


def test_pallas_conv_keeps_the_chain_at_batch_one(monkeypatch):
    """At batch 1 the residual chain stays with K2: K4 takes no conv, so
    the streaming paths keep their launch counts."""
    spec, params, _ = tckpt.load_model("demo", device="cpu")
    calls = _count_k4(monkeypatch)
    x = torch.randn(1, 48, 64, 7) * 60
    tsty.apply(params, spec, x, fused=True)
    assert calls == []
    tsty.apply(params, spec, torch.cat([x, x]), fused=True)
    assert len(calls) == 10


# ---------------------------------------------------------------------------
# init, counts and the batch engine
# ---------------------------------------------------------------------------

def test_init_params_matches_jax_tree():
    spec, tspec = parse_both("canonical", in_channels=7)
    jtree = jax.eval_shape(lambda: jsty.init_params(jax.random.PRNGKey(0), spec))
    pt = tsty.init_params(torch.Generator().manual_seed(0), tspec, device="cpu")

    def shapes(tree, oihw):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = shapes(v, oihw)
            else:
                s = tuple(v.shape)
                out[k] = (s[3], s[2], s[0], s[1]) if (oihw and len(s) == 4) else s
        return out
    assert shapes(pt, False) == shapes(jtree, True)
    jcount = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jtree))
    assert tsty.count_params(pt) == jcount
    w = pt["layer00"]["w"]
    stdv = 1.0 / np.sqrt(9 * 9 * 7)
    assert float(w.abs().max()) <= stdv and float(w.std()) > 0.5 * stdv
    spec_b, init_fn, apply_fn = tsty.build("c3s1-8,R8,c3s1-3", in_channels=7)
    p = init_fn(torch.Generator().manual_seed(1), device="cpu")
    assert apply_fn(p, torch.zeros(1, 16, 16, 7)).shape == (1, 16, 16, 3)
    assert tsty.count_params(p) == sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jsty.init_params(jax.random.PRNGKey(1), spec_b))))


def test_stylize_batch_mixed_sizes_matches_jax():
    spec, pj, _ = jckpt.load_model("demo")
    tspec, pt, _ = tckpt.load_model("demo", device="cpu")
    je = jeng.StylizerEngine(lambda p, x: jsty.apply(p, spec, x, optimize=False), pj,
                             stride_multiple=spec.total_stride)
    te = teng.StylizerEngine(lambda p, x: tsty.apply(p, tspec, x, fused=True), pt,
                             stride_multiple=tspec.total_stride, device="cpu")
    rng = np.random.default_rng(23)
    frames = [(rng.random(s) * 255).astype(np.uint8)
              for s in ((48, 64, 3), (50, 70, 3), (45, 61, 3))]
    want = je.stylize_batch(frames)
    got = te.stylize_batch(frames)
    for f, g, w in zip(frames, got, want):
        assert tuple(g.shape) == f.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-3
    # independent frames: each equals its own stylize_first at that size
    one = te.stylize_first(frames[1])
    assert (one - got[1]).abs().max() <= 1e-3


# ---------------------------------------------------------------------------
# the CLI's batched mode
# ---------------------------------------------------------------------------

def test_port_cli_inconsistent_batch_matches_jax_cli(batch_fixture, tmp_path):
    got, want = port_cli_case(batch_fixture, "batch", tmp_path)
    assert got.shape == want.shape
    err = _mean_abs(got, want)
    assert (err <= 1e-2).all(), err


@pytest.mark.parametrize("case", ["batch", "reuse", "scale", "phase"])
def test_batch_fixture_matches_live_jax_run(batch_fixture, tmp_path, case):
    """Each committed fixture case against a live JAX CLI run."""
    from tests.test_torch_cli import _tool

    tool = _tool()
    assert sorted(tool.BATCH_CASES) == sorted(["batch", "reuse", "scale", "phase"])
    frames = tool.pan_frames(int(batch_fixture["seed"]), tool.BATCH_FRAMES, tool.BATCH_H,
                             tool.BATCH_W, step=tuple(int(v) for v in batch_fixture["step"]))
    np.testing.assert_array_equal(frames, batch_fixture["frames"])
    extra, n = tool.BATCH_CASES[case]
    assert list(batch_fixture[f"args_{case}"]) == extra
    live = tool.run_jax_cli(frames[:n], str(tmp_path), extra)
    assert np.abs(live.astype(int) - batch_fixture[f"outputs_{case}"].astype(int)).max() <= 1
