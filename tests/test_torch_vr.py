"""The port's VR slice (fast_artistic_videos_tpu_torch: video.vr_geometry,
the VR filters, ops.warp.make_static_warp, kernel K5's plain version,
engine.stylize_with_prior, the batched flow provider, video.driver_vr and
cli.stylize_vr_video) against the JAX package, on the same seeded numpy
inputs. Tolerances: geometry, filters and masks exact; warps float32 1e-5;
the engine 1e-4 relative; flows the 1e-3 px bound of test_torch_flow.py;
the CLI's uint8 faces a mean-abs of 1e-2 (of the [0, 1] range) per face."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu.flow import estimator as jest
from fast_artistic_videos_tpu.flow import provider as jprov
from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.ops import filters as jfilters
from fast_artistic_videos_tpu.ops import warp as jwarp
from fast_artistic_videos_tpu.ops import warp_pallas
from fast_artistic_videos_tpu.video import engine as jeng
from fast_artistic_videos_tpu.video import vr_geometry as jvr
from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as tcli
from fast_artistic_videos_tpu_torch.flow import estimator as test_
from fast_artistic_videos_tpu_torch.flow import provider as tprov
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import filters as tfilters
from fast_artistic_videos_tpu_torch.ops import strip_warp_kernel
from fast_artistic_videos_tpu_torch.ops import warp as twarp
from fast_artistic_videos_tpu_torch.video import driver_vr as tdrv
from fast_artistic_videos_tpu_torch.video import engine as teng
from fast_artistic_videos_tpu_torch.video import vr_geometry as tvr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parity_vr.npz")
MAPS = ("left", "right", "top", "bottom")


def _tool():
    path = os.path.join(ROOT, "tools", "make_torch_parity_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_parity_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _map(geo, name, face, overlap):
    fn = getattr(geo, f"perspective_warp_map_{name}")
    return fn(face, overlap, face)


# ---------------------------------------------------------------------------
# geometry and filters (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MAPS)
def test_border_maps_match_jax(name):
    np.testing.assert_array_equal(_map(tvr, name, 40, 12), _map(jvr, name, 40, 12))


def test_equirect_map_and_rotations_match_jax():
    np.testing.assert_array_equal(tvr.cube_to_equirectangular_map(32, 32, 8, 8, 64, 32),
                                  jvr.cube_to_equirectangular_map(32, 32, 8, 8, 64, 32))
    x = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    for name in ("rotate90", "rotate_minus90", "rotate180"):
        want = np.asarray(getattr(jvr, name)(x))
        got_np = getattr(tvr, name)(x)
        got_t = getattr(tvr, name)(torch.from_numpy(x))
        assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)


def test_equirect_to_faces_matches_jax():
    """The equirect -> cube-face split warps with the port's exact gather."""
    equi = np.random.default_rng(2).random((24, 48, 3)).astype(np.float32)
    got = tvr.equirect_to_faces(equi, 20, 20, 4, 4)
    want = jvr.equirect_to_faces(equi, 20, 20, 4, 4)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5, 6]
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [3, 5])
def test_median_filter_matches_jax(size):
    x = np.random.default_rng(size).random((2, 13, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(tfilters.median_filter(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jfilters.median_filter(jnp.asarray(x), size)))
    np.testing.assert_array_equal(
        tfilters.median_filter(torch.from_numpy(x[0, ..., 0]), size).numpy(),
        np.asarray(jfilters.median_filter(jnp.asarray(x[0, ..., 0]), size)))


def test_gradient_masks_match_jax():
    for name in ("h_inc", "h_dec", "w_inc", "w_dec"):
        got = getattr(tfilters, f"gradient_mask_{name}")(9, 14).numpy()
        want = np.asarray(getattr(jfilters, f"gradient_mask_{name}")(9, 14))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the static warps: make_static_warp and K5's plain version (float32 1e-5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("batched,c", [(False, 3), (True, 1)])
def test_make_static_warp_matches_jax(name, batched, c):
    m = _map(jvr, name, 48, 16)
    shape = (3, 48, 48, c) if batched else (48, 48, c)
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(jax.jit(jwarp.make_static_warp(m))(jnp.asarray(img)))
    got = twarp.make_static_warp(m)(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("face,overlap", [(32, 12), (48, 16)])
def test_strip_warp_plain_matches_jax_gather(face, overlap):
    """K5's plain version on the four maps against the JAX exact strip
    gather, one image and a batch of two sharing the map."""
    rng = np.random.default_rng(face)
    img = rng.random((face, face, 3)).astype(np.float32)
    batch = rng.random((2, face, face, 3)).astype(np.float32)
    for name in MAPS:
        m = _map(jvr, name, face, overlap)
        fn = strip_warp_kernel.make_static_strip_warp(m)
        assert fn is not None, name
        for x in (img, batch):
            got = fn(torch.from_numpy(x)).numpy()
            want = np.asarray(jax.jit(jwarp.make_static_warp(m))(jnp.asarray(x)))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_strip_warp_plain_matches_jax_pallas():
    """K5's plain version against the JAX Pallas strip warp it replaces
    (interpret mode, as tests/test_warp_pallas.py runs it)."""
    img = np.random.default_rng(5).random((32, 32, 3)).astype(np.float32)
    for name in MAPS:
        m = _map(jvr, name, 32, 12)
        got = strip_warp_kernel.make_static_strip_warp(m)(torch.from_numpy(img)).numpy()
        want = np.asarray(warp_pallas.make_static_strip_warp(m, interpret=True)(
            jnp.asarray(img)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_strip_warp_rejects_nonseparable_maps():
    equi = jvr.cube_to_equirectangular_map(32, 32, 8, 8, 64, 32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    swirl = np.stack([np.sin(yy / 5.0) * 3.0, np.cos(xx / 7.0) * 3.0], axis=-1)
    for m in (equi, swirl):
        assert warp_pallas.make_static_strip_warp(m) is None
        assert strip_warp_kernel.make_static_strip_warp(m) is None


# ---------------------------------------------------------------------------
# engine.stylize_with_prior (float32, 1e-4 relative)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("erode", [True, False])
def test_stylize_with_prior_matches_jax(erode):
    spec, pj, _ = jckpt.load_model("demo")
    tspec, pt, _ = tckpt.load_model("demo", device="cpu")
    je = jeng.StylizerEngine(lambda p, x: jsty.apply(p, spec, x), pj,
                             stride_multiple=spec.total_stride)
    te = teng.StylizerEngine(lambda p, x: tsty.apply(p, tspec, x), pt,
                             stride_multiple=tspec.total_stride, device="cpu")
    rng = np.random.default_rng(7)
    content = rng.random((46, 50, 3)).astype(np.float32)    # stride padding
    prior = rng.random((46, 50, 3)).astype(np.float32)
    cert = (rng.random((46, 50)) > 0.3).astype(np.float32)
    want = np.asarray(je.stylize_with_prior(content, prior, cert, erode_cert=erode))
    got = te.stylize_with_prior(torch.from_numpy(content), torch.from_numpy(prior),
                                torch.from_numpy(cert), erode_cert=erode).numpy()
    assert got.shape == want.shape == (46, 50, 3)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# the batched flow provider (flows 1e-3 px; masks and bands exact)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def estimators():
    return (jest.FlowEstimator(jest.load_params("bundled")),
            test_.FlowEstimator(test_.load_params("bundled", device="cpu"), device="cpu"))


@pytest.mark.parametrize("fast_check", [False, True])
def test_batched_provider_matches_jax(estimators, fast_check):
    je, te = estimators
    faces = _tool().vr_faces(seed=3, n=3, face=48, step=(3, 1))
    jp = jprov.BatchedStreamingFlowProvider(flow_estimator=je, flow_scale=0.5,
                                            fast_check=fast_check)
    tp = tprov.BatchedStreamingFlowProvider(flow_estimator=te, flow_scale=0.5,
                                            fast_check=fast_check)
    for t, frame in enumerate(faces):
        x = frame.astype(np.float32) / 255.0
        want = jp(jnp.asarray(x))
        got = tp(torch.from_numpy(x))
        if t == 0:
            assert want is None and got is None
            continue
        assert tp.last_band == jp.last_band
        assert len(got) == len(want) == 6
        for (gf, gc), (wf, wc) in zip(got, want):
            assert np.abs(gf.numpy() - np.asarray(wf)).max() <= 1e-3
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


# ---------------------------------------------------------------------------
# the driver and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _mean_abs(a, b):
    return np.abs(a.astype(np.float32) - b.astype(np.float32)).mean(axis=(-3, -2, -1)) / 255.0


def _port_cli(tool, pattern, prefix, *extra):
    tcli.main(["--input_pattern", pattern, "--output_prefix", prefix, "--device", "cpu",
               *tool.VR_ARGS, *extra])


def test_fixture_matches_live_jax_vr_run(fixture, tmp_path):
    tool = _tool()
    faces = tool.vr_faces(int(fixture["seed"]), len(fixture["faces"]),
                          fixture["faces"].shape[2], tuple(int(v) for v in fixture["step"]))
    np.testing.assert_array_equal(faces, fixture["faces"])
    live = tool.run_jax_vr_cli(faces, str(tmp_path))
    assert np.abs(live.astype(int) - fixture["outputs"].astype(int)).max() <= 1


def test_port_vr_cli_matches_jax_cli(fixture, tmp_path):
    tool = _tool()
    prefix = os.path.join(tmp_path, "out", "o")
    _port_cli(tool, tool.write_vr_faces(fixture["faces"], str(tmp_path)), prefix)
    got = tool.read_vr_outputs(prefix, len(fixture["faces"]))
    assert got.shape == fixture["outputs"].shape
    err = _mean_abs(got, fixture["outputs"])
    assert (err <= 1e-2).all(), err


def test_port_vr_cli_resume(fixture, tmp_path):
    """--continue_with 2 after frames 1-2: the resumed run reloads frame 2's
    blended faces, primes the provider with frame 2's input faces, and
    frame 3 still agrees with the uninterrupted JAX run."""
    tool = _tool()
    pattern = tool.write_vr_faces(fixture["faces"], str(tmp_path))
    prefix = os.path.join(tmp_path, "out", "o")
    _port_cli(tool, pattern, prefix, "--num_frames", "2")
    _port_cli(tool, pattern, prefix, "--continue_with", "2")
    got = tool.read_vr_outputs(prefix, len(fixture["faces"]))
    err = _mean_abs(got, fixture["outputs"])
    assert (err <= 1e-2).all(), err


def test_evaluate_raises_and_names_roadmap(tmp_path):
    """--evaluate is carried since the evaluation slice (tests/
    test_torch_vr_eval.py); without a loss network it raises before any
    face is stylized, naming the flag it needs."""
    with pytest.raises(ValueError, match="--loss_network"):
        tcli.main(["--input_pattern", os.path.join(tmp_path, "f%04d_%d.ppm"),
                   "--model_vid", "demo", "--create_inconsistent", "--evaluate",
                   "--device", "cpu"])


HP = WP = 48
OVERLAP = 16


def _echo_engines():
    """Engines whose 'stylizer' returns the prior channels: the outputs are
    the driver's priors, so the border and blend mechanics show directly."""
    cfg = dict(occlusions_min_filter=3)
    je = jeng.StylizerEngine(lambda p, x: x[..., 3:6], params_vid=None, stride_multiple=1,
                             config=jeng.EngineConfig(**cfg))
    te = teng.StylizerEngine(lambda p, x: x[..., 3:6], params_vid=None, stride_multiple=1,
                             config=teng.EngineConfig(**cfg), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def vr_clip(tmp_path_factory):
    """Two frames of 6 random faces with file-pattern flow and certainty
    (a small pan and a certainty hole), as tests/test_vr.py builds them."""
    tmp_path = tmp_path_factory.mktemp("vr_clip")
    rng = np.random.default_rng(0)
    (tmp_path / "flow").mkdir()
    for f in (1, 2):
        for face in range(1, 7):
            io.save_image(str(tmp_path / f"f{f:04d}_{face}.ppm"),
                          rng.random((HP, WP, 3)).astype(np.float32))
    for face in range(1, 7):
        flow = np.zeros((HP, WP, 2), np.float32)
        flow[..., 0], flow[..., 1] = 1.5, -0.5
        io.write_flo(str(tmp_path / "flow" / f"backward_2_1_{face}.flo"), flow)
        cert = np.full((HP, WP), 255, np.uint8)
        cert[10:20, 5:30] = 0
        io.write_pgm(str(tmp_path / "flow" / f"reliable_2_1_{face}.pgm"), cert)
    return tmp_path


_OUTPUTS = [f"o{f}_{p}.png" for f in (1, 2) for p in range(6)] + [
    "o-00002_cubemap.png", "o-00002_equi.png"]


def _file_pattern_run(vr_clip, options, driver, engine, tag, **kw):
    opt = options(input_pattern=str(vr_clip / "f%04d_%d.ppm"),
                  flow_pattern=str(vr_clip / "flow" / "backward_[%d]_{%d}_%d.flo"),
                  occlusions_pattern=str(vr_clip / "flow" / "reliable_[%d]_{%d}_%d.pgm"),
                  output_prefix=str(vr_clip / tag / "o"), num_frames=2,
                  overlap_pixel_w=OVERLAP, overlap_pixel_h=OVERLAP, median_filter=3,
                  out_cubemap=True, out_equi=True, out_equi_w=64, out_equi_h=32,
                  smooth_certainty=True, **kw)
    assert driver(engine, opt).run(progress=False) == 12
    return [io.load_image_u8(str(vr_clip / tag / name)) for name in _OUTPUTS]


@pytest.fixture(scope="module")
def jax_file_pattern_outputs(vr_clip):
    from fast_artistic_videos_tpu.video.driver_vr import VRDriver, VROptions

    return _file_pattern_run(vr_clip, VROptions, VRDriver, _echo_engines()[0], "j")


@pytest.mark.parametrize("strip_kernel", [None, False])
def test_file_pattern_driver_matches_jax(vr_clip, jax_file_pattern_outputs, strip_kernel):
    """The staged path (load_cert / make_prior, flow and certainty from
    files) with the equirect and cubemap outputs and smooth_certainty,
    through K5's plain version (None) and the exact strip gather (False):
    every uint8 output within one step of the JAX driver's."""
    got = _file_pattern_run(vr_clip, tdrv.VROptions, tdrv.VRDriver, _echo_engines()[1],
                            f"t{strip_kernel}", pallas_strip_warp=strip_kernel)
    for name, a, b in zip(_OUTPUTS, got, jax_file_pattern_outputs):
        assert a.shape == b.shape, name
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
