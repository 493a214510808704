"""Feature reuse, --scale_factor, --phase_resident and stylize_video_file in
the port against the JAX package, on the CPU: the engine's keyframe and
reuse steps (outputs and deltas) on the canonical arch with JAX
``init_params`` weights, ``warp_weight_map``, ``flow_magnitude_mask``, the
bicubic resize against ``jax.image.resize``, and the port CLI's modes
against the JAX CLI's outputs in ``tests/fixtures/torch_parity_batch.npz``
(mean-abs <= 1e-2 per frame; --phase_resident also within one uint8 step).
Inputs are made with numpy from a seed."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import arch_dsl
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.ops import filters as jfilters
from fast_artistic_videos_tpu.ops import warp as jwarp
from fast_artistic_videos_tpu.video import engine as jeng
from fast_artistic_videos_tpu_torch.cli import stylize_video as tcli
from fast_artistic_videos_tpu_torch.core import config
from fast_artistic_videos_tpu_torch.models import arch_dsl as tarch
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import filters as tfilters
from fast_artistic_videos_tpu_torch.ops import warp as twarp
from fast_artistic_videos_tpu_torch.video import driver_video as tdrv
from fast_artistic_videos_tpu_torch.video import engine as teng
from tests.test_torch_batch import batch_fixture, port_cli_case  # noqa: F401
from tests.test_torch_cli import _mean_abs, _read, _write_frames


# ---------------------------------------------------------------------------
# the engine's feature-reuse steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reuse_engines():
    """(JAX engine, port engine) on the canonical arch with the same JAX
    init_params weights, occlusion min-filter 3. The port's split apply
    takes the kernel wiring (K3 front off at the tap, K2 chain in the
    keyframe's middle segment) through the plain versions."""
    spec = arch_dsl.parse_arch("canonical", in_channels=7)
    tspec = tarch.parse_arch("canonical", in_channels=7)
    pj = jsty.init_params(jax.random.PRNGKey(0), spec)
    pt = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    plan = jsty.reuse_split_plan(spec)
    assert tsty.reuse_split_plan(tspec) == plan == (2, 8, 10)
    cfg = dict(occlusions_min_filter=3)
    je = jeng.StylizerEngine(
        lambda p, x: jsty.apply(p, spec, x, optimize=False), pj,
        stride_multiple=spec.total_stride, config=jeng.EngineConfig(**cfg),
        apply_vid_split=lambda p, x, **kw: jsty.apply(p, spec, x, optimize=False, **kw),
        reuse_plan=plan)
    te = teng.StylizerEngine(
        lambda p, x: tsty.apply(p, tspec, x, fused=True), pt,
        stride_multiple=tspec.total_stride, config=teng.EngineConfig(**cfg), device="cpu",
        apply_vid_split=lambda p, x, **kw: tsty.apply(p, tspec, x, fused=True, **kw),
        reuse_plan=plan)
    assert te.supports_feature_reuse
    return je, te


def _step_inputs(seed, h=48, w=64, flow_scale=2.0):
    rng = np.random.default_rng(seed)
    content = rng.random((h, w, 3)).astype(np.float32)
    prev = rng.random((h, w, 3)).astype(np.float32)
    flow = (rng.standard_normal((h, w, 2)) * flow_scale).astype(np.float32)
    cert = (rng.random((h, w)) > 0.2).astype(np.float32)
    return content, prev, flow, cert


def test_keyframe_matches_jax_and_exact_step(reuse_engines):
    je, te = reuse_engines
    content, prev, flow, cert = _step_inputs(5)
    want, want_delta = je.stylize_next_full(content, prev, flow, cert, band_hint=8)
    got, delta = te.stylize_next_full(content, prev, flow, cert, band_hint=8)
    # the demo-size reflect pre-pad (40 px) needs frames of at least 41 px
    assert tuple(got.shape) == (48, 64, 3) and tuple(delta.shape) == (12, 16, 128)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), atol=2e-3, rtol=1e-4)
    # the keyframe is the exact step split at the residual chain
    exact = te.stylize_next(content, prev, flow, cert, 8)
    assert (exact - got).abs().max() <= 1e-4


@pytest.mark.parametrize("band_hint", [8, None])
def test_reuse_step_matches_jax(reuse_engines, band_hint):
    """The reuse step from the same keyframe delta: the frame and the
    advected delta (banded warp at qband = flow_band(band / 4), or the exact
    gather with band None)."""
    je, te = reuse_engines
    content, prev, flow, cert = _step_inputs(6)
    _, delta_j = je.stylize_next_full(content, prev, flow, cert, band_hint=8)
    c2, p2, f2, k2 = _step_inputs(7, flow_scale=3.0)
    want, want_dw = je.stylize_next_reuse(c2, p2, f2, k2, delta_j, band_hint=band_hint)
    got, dw = te.stylize_next_reuse(c2, p2, f2, k2, torch.from_numpy(np.array(delta_j)),
                                    band_hint=band_hint)
    assert tuple(got.shape) == (48, 64, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-4)


def test_reuse_static_scene_equals_keyframe(reuse_engines):
    """Zero flow, full certainty, the same inputs: the advected delta is
    the keyframe's, so the reuse frame equals the keyframe."""
    _, te = reuse_engines
    content, prev, _, _ = _step_inputs(8)
    flow = np.zeros((48, 64, 2), np.float32)
    cert = np.ones((48, 64), np.float32)
    full, delta = te.stylize_next_full(content, prev, flow, cert)
    out, delta2 = te.stylize_next_reuse(content, prev, flow, cert, delta)
    assert (out - full).abs().max() <= 2e-5
    assert (delta2 - delta).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# helpers: weight map, magnitude mask, resize
# ---------------------------------------------------------------------------

def test_warp_weight_map_and_magnitude_mask_match_jax():
    rng = np.random.default_rng(9)
    flow = (rng.standard_normal((2, 21, 30, 2)) * 6).astype(np.float32)
    want = np.asarray(jwarp.warp_weight_map(jnp.asarray(flow), 21, 30))
    got = twarp.warp_weight_map(torch.from_numpy(flow), 21, 30).numpy()
    assert got.shape == want.shape == (2, 21, 30)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for m in (1.0, 7.5):
        want = np.asarray(jfilters.flow_magnitude_mask(jnp.asarray(flow), m))
        got = tfilters.flow_magnitude_mask(torch.from_numpy(flow), m).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("channels", [3, 2, 1])
@pytest.mark.parametrize("scale", [0.5, 0.75, 2.0])
def test_resize_bicubic_matches_jax(channels, scale):
    from fast_artistic_videos_tpu.video import driver_video as jdrv

    arr = np.random.default_rng(channels).random((38, 54, channels)).astype(np.float32)
    want = np.asarray(jdrv._resize_bicubic(arr, scale))
    got = tdrv.resize_bicubic(torch.from_numpy(arr), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# the CLI's modes against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reuse", "scale", "phase"])
def test_port_cli_mode_matches_jax_cli(batch_fixture, tmp_path, name):  # noqa: F811
    got, want = port_cli_case(batch_fixture, name, tmp_path)
    assert got.shape == want.shape
    err = _mean_abs(got, want)
    assert (err <= 1e-2).all(), err
    if name == "phase":
        # the JAX CLI's own bound between its phase-resident and plain runs
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stylize_video_file_frames_dir(batch_fixture, tmp_path):  # noqa: F811
    """stylize_video_file --frames_dir --no_encode (streaming flow, float32)
    against the JAX package's stylize_video_file on the same frames."""
    from fast_artistic_videos_tpu.cli import stylize_video_file as jfile
    from fast_artistic_videos_tpu_torch.cli import stylize_video_file

    d = tmp_path / "frames"
    d.mkdir()
    _write_frames(batch_fixture["frames"][:2], str(d))
    args = ["--frames_dir", str(d), "--model_vid", "demo", "--flow_model", "bundled",
            "--dtype", "float32", "--no_encode"]
    assert jfile.main(args + ["--out_dir", str(tmp_path / "j")]) == 0
    assert stylize_video_file.main(args + ["--out_dir", str(tmp_path / "t"),
                                          "--device", "cpu"]) == 0
    err = _mean_abs(_read(str(tmp_path / "t" / "out"), (1, 2)),
                    _read(str(tmp_path / "j" / "out"), (1, 2)))
    assert (err <= 1e-2).all(), err


def test_stylize_video_file_unported_and_missing_ffmpeg(tmp_path, monkeypatch):
    from fast_artistic_videos_tpu_torch.cli import stylize_video_file

    # --flow_background is carried since the flow-file slice
    # (tests/test_torch_flow_files.py); like the streaming path it needs
    # --flow_model
    with pytest.raises(SystemExit):
        stylize_video_file.main(["--frames_dir", str(tmp_path), "--model_vid", "demo",
                                 "--flow_background"])
    monkeypatch.setattr(stylize_video_file.shutil, "which", lambda name: None)
    with pytest.raises(SystemExit, match="ffmpeg/avconv not found"):
        stylize_video_file.main([str(tmp_path / "v.mp4"), "--model_vid", "demo",
                                 "--flow_model", "bundled", "--out_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# erosion parity: the provider erodes only where the JAX CLI lets it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,eroded", [
    ([], True), (["--feature_reuse", "3"], False), (["--scale_factor", "0.5"], False),
    (["--phase_resident"], False), (["--flow_scale", "1.0"], False)])
def test_cli_erode_window_conditions(extra, eroded):
    args = argparse.ArgumentParser()
    tcli.add_stylize_flags(args)
    opt = tcli.options_from_args(args.parse_args(
        ["--flow_model", "bundled", "--flow_scale", "0.5", *extra]))
    provider = tcli.build_flow_provider(opt, torch.device("cpu"))
    assert bool(provider.erode_window) == eroded


def test_driver_refuses_eroded_provider_with_reuse(reuse_engines):
    class Eroding:
        erode_window = 7

        def __call__(self, frame):
            return None
    opt = config.StylizeOptions(input_pattern="none_%05d.ppm", feature_reuse=3,
                                num_frames=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tdrv.VideoDriver(reuse_engines[1], opt, flow_provider=Eroding()).run()
