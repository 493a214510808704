"""The port's VR evaluation and the rest of its VR slice
(fast_artistic_videos_tpu_torch: VREvaluator through cli.stylize_vr_video
--evaluate, VRDriver's flow_provider_factory, cli.transform_vr and
cli.stylize_vr_video_file --frames_dir) against the JAX package, on the same
seeded inputs, on the CPU. Tolerances: the two VR CLIs' evaluation files
1e-3 relative per series value (their stylized faces differ by float32
rounding), the faces and equirect frames of two runs a mean-abs of 1e-2
(of the [0, 1] range), transform_vr's faces within one uint8 step."""

import importlib.util
import os

import jax
import numpy as np
import pytest

from fast_artistic_videos_tpu.cli import stylize_vr_video as jcli
from fast_artistic_videos_tpu.cli import stylize_vr_video_file as jfile
from fast_artistic_videos_tpu.cli import transform_vr as jtransform
from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu.flow import provider as jprov
from fast_artistic_videos_tpu.flow import estimator as jest
from fast_artistic_videos_tpu.models import arch_dsl, checkpoint as jckpt, stylizer as jsty
from fast_artistic_videos_tpu.models import registry
from fast_artistic_videos_tpu.video import driver_vr as jdrv
from fast_artistic_videos_tpu.video import engine as jeng
from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as tcli
from fast_artistic_videos_tpu_torch.cli import stylize_vr_video_file as tfile
from fast_artistic_videos_tpu_torch.cli import transform_vr as ttransform
from fast_artistic_videos_tpu_torch.flow import estimator as test_
from fast_artistic_videos_tpu_torch.flow import provider as tprov
from fast_artistic_videos_tpu_torch.video import driver_vr as tdrv
from fast_artistic_videos_tpu_torch.video import engine as teng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    path = os.path.join(ROOT, "tools", "make_torch_parity_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_parity_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mean_abs(a, b):
    return np.abs(a.astype(np.float32) - b.astype(np.float32)).mean() / 255.0


def _eval_file(path):
    lines = open(path).read().strip().split("\n")
    n = len(lines) // 2
    return (np.asarray([[float(v) for v in line.split(";")] for line in lines[:n]]),
            np.asarray([float(v) for v in lines[n:]]))


def test_vr_cli_evaluate_matches_jax(tmp_path):
    """Both VR CLIs on 2 frames of the VR fixture's faces, stylized and
    scored with the pan's ground-truth flow and certainty per face: seven
    series of 12 values and their means, within 1e-3 relative."""
    tool = _tool()
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_vr.npz")) as z:
        faces, step, overlap = z["faces"][:2], tuple(int(v) for v in z["step"]), int(z["overlap"])
    pattern = tool.write_vr_faces(faces, str(tmp_path))
    flow_pat, cert_pat = tool.write_pan_flow(str(tmp_path), len(faces), *faces.shape[2:4],
                                             step, faces=range(1, 7))
    vgg = tool.vgg_npz(tool.EVAL_VGG_SEED, str(tmp_path / "vgg16.npz"))
    args = ["--input_pattern", pattern, "--model_vid", "demo",
            "--flow_pattern", flow_pat, "--occlusions_pattern", cert_pat,
            "--overlap_pixel_w", str(overlap), "--overlap_pixel_h", str(overlap),
            "--num_frames", "2", "--evaluate", "--loss_network", vgg,
            "--style_image", registry.style_fixture("candy"), "--style_image_size", "64"]
    jcli.main(args + ["--output_prefix", str(tmp_path / "j" / "o"),
                      "--evaluation_file", str(tmp_path / "j.txt")])
    tcli.main(args + ["--output_prefix", str(tmp_path / "t" / "o"),
                      "--evaluation_file", str(tmp_path / "t.txt"), "--device", "cpu"])
    js, jm = _eval_file(str(tmp_path / "j.txt"))
    ts, tm = _eval_file(str(tmp_path / "t.txt"))
    assert ts.shape == js.shape == (7, 12)
    assert (ts[6, :6] == 0).all() and (ts[6, 6:] > 0).all()     # temporal from frame 2
    assert (np.abs(ts).max(axis=1) > 0).all()
    np.testing.assert_allclose(ts, js, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(tm, jm, rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def pan_faces(tmp_path_factory):
    """2 frames of six 48-px pan faces (overlap 16) on disk."""
    d = tmp_path_factory.mktemp("pan_faces")
    tool = _tool()
    faces = tool.vr_faces(seed=5, n=2, face=48, step=(3, 1))
    return tool.write_vr_faces(faces, str(d)), d


def test_flow_provider_factory_matches_jax(pan_faces):
    """One streaming provider per face position (the bundled estimator at
    half resolution) with engines that echo their prior: the same faces as
    the JAX driver's factory run, every face stream fed."""
    pattern, d = pan_faces
    kw = dict(input_pattern=pattern, num_frames=2, overlap_pixel_w=16, overlap_pixel_h=16,
              median_filter=0)
    cfg = dict(occlusions_min_filter=3)
    jshared = jest.FlowEstimator(jest.load_params(registry.bundled_flow_weights()))
    je = jeng.StylizerEngine(lambda p, x: x[..., 3:6], params_vid=None, stride_multiple=1,
                             config=jeng.EngineConfig(**cfg))
    jd = jdrv.VRDriver(je, jdrv.VROptions(output_prefix=str(d / "j" / "o"), **kw),
                       flow_provider_factory=lambda: jprov.StreamingFlowProvider(
                           flow_estimator=jshared, flow_scale=0.5))
    assert jd.run(progress=False) == 12
    tshared = test_.FlowEstimator(test_.load_params("bundled", "cpu"), device="cpu")
    te = teng.StylizerEngine(lambda p, x: x[..., 3:6], params_vid=None, stride_multiple=1,
                             config=teng.EngineConfig(**cfg), device="cpu")
    made = []

    def factory():
        made.append(tprov.StreamingFlowProvider(flow_estimator=tshared, flow_scale=0.5))
        return made[-1]
    td = tdrv.VRDriver(te, tdrv.VROptions(output_prefix=str(d / "t" / "o"), **kw),
                       flow_provider_factory=factory)
    assert td.run(progress=False) == 12
    assert len(made) == 6 and td.streaming and td.batched_flow is None
    assert all(s is not None for s in td._streamed)
    for f in (1, 2):
        for pos in range(6):
            got = io.load_image_u8(str(d / "t" / f"o{f}_{pos}.png"))
            want = io.load_image_u8(str(d / "j" / f"o{f}_{pos}.png"))
            assert _mean_abs(got, want) <= 1e-2, (f, pos)


def test_transform_vr_matches_jax(tmp_path):
    eq = np.random.default_rng(0).random((32, 64, 3)).astype(np.float32)
    for f in (1, 2):
        io.save_image(str(tmp_path / f"equi_{f:05d}.png"), np.roll(eq, f, axis=1))
    args = ["--input_pattern", str(tmp_path / "equi_%05d.png"), "--face_size", "16",
            "--overlap_pixel_w", "4", "--overlap_pixel_h", "4"]
    assert jtransform.main(args + ["--output_pattern", str(tmp_path / "j" / "f%04d_%d.ppm")]) == 0
    assert ttransform.main(args + ["--output_pattern", str(tmp_path / "t" / "f%04d_%d.ppm")]) == 0
    for f in (1, 2):
        for n in range(1, 7):
            got = io.load_image_u8(str(tmp_path / "t" / f"f{f:04d}_{n}.ppm"))
            want = io.load_image_u8(str(tmp_path / "j" / f"f{f:04d}_{n}.ppm"))
            assert got.shape == want.shape == (20, 20, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_stylize_vr_video_file_matches_jax(tmp_path):
    """The one-command VR pipeline with --frames_dir (no ffmpeg) on the clip
    of tests/test_vr.py's one-command test: equirect frames in, face split,
    batched streaming flow (random estimator weights), stylization (random
    small model), equirect frames out; float32 on both sides."""
    rng = np.random.default_rng(3)
    equi_dir = tmp_path / "equi"
    equi_dir.mkdir()
    base = rng.random((48, 96, 3)).astype(np.float32)
    for f in (1, 2):
        io.save_image(str(equi_dir / f"equi_{f:05d}.ppm"), np.roll(base, (f - 1) * 2, axis=1))
    arch = "c3s1-8,d16,R16,U2,c3s1-3"
    spec = arch_dsl.parse_arch(arch, in_channels=7)
    model = str(tmp_path / "vid.npz")
    jckpt.save_model(model, jsty.init_params(jax.random.PRNGKey(0), spec),
                     {"arch": arch, "in_channels": 7, "padding_type": "reflect-start",
                      "use_instance_norm": True, "tanh_constant": 150.0})
    flow_model = str(tmp_path / "flow.npz")
    jest.save_params(flow_model, jest.init_params(jax.random.PRNGKey(1)))
    args = ["--frames_dir", str(equi_dir), "--model_vid", model, "--flow_model", flow_model,
            "--face_size", "16", "--overlap_pixel_w", "12", "--overlap_pixel_h", "12",
            "--dtype", "float32"]
    assert jfile.main(args + ["--out_dir", str(tmp_path / "j")]) == 0
    assert tfile.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    for f in (1, 2):
        got = io.load_image_u8(str(tmp_path / "t" / f"out-{f:05d}_equi.png"))
        want = io.load_image_u8(str(tmp_path / "j" / f"out-{f:05d}_equi.png"))
        assert got.shape == want.shape == (48, 96, 3)
        assert got.std() > 2.0
        assert _mean_abs(got, want) <= 1e-2, f
    # per-face intermediates are cleaned up by default
    assert not os.path.exists(str(tmp_path / "t" / "out1_0.png"))
