"""The port's evaluation slice (fast_artistic_videos_tpu_torch: ops.gram,
models.vgg, train.losses, video.evaluation, the 2D driver's eval_fn and the
CLI's --evaluate) against the JAX package, on the same seeded numpy inputs
and the same full-width VGG-16 .npz (made from a numpy seed by
tools/make_torch_parity_fixture.py's vgg_npz). Tolerances: the Gram matrix
and the seam metrics 1e-5 relative; VGG taps 1e-4 of each tap's largest
value; the perceptual losses, the scorer and the temporal error 1e-4
relative; the evaluation files of the two CLIs on the same frames and
flows 1e-3 relative (the two stylizers' outputs differ by float32
rounding); the committed evaluator fixture against a live JAX run 1e-6
relative, and the port against it 1e-4."""

import dataclasses
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.cli import stylize_video as jcli
from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu.core.config import StylizeOptions as JOptions
from fast_artistic_videos_tpu.models import registry as jreg
from fast_artistic_videos_tpu.models import t7 as jt7
from fast_artistic_videos_tpu.models import vgg as jvgg
from fast_artistic_videos_tpu.ops import gram as jgram
from fast_artistic_videos_tpu.train import losses as jlosses
from fast_artistic_videos_tpu.video import evaluation as jev
from fast_artistic_videos_tpu_torch.cli import stylize_video as tcli
from fast_artistic_videos_tpu_torch.core import device as device_mod
from fast_artistic_videos_tpu_torch.core.config import StylizeOptions as TOptions
from fast_artistic_videos_tpu_torch.models import registry as treg
from fast_artistic_videos_tpu_torch.models import vgg as tvgg
from fast_artistic_videos_tpu_torch.ops import gram as tgram
from fast_artistic_videos_tpu_torch.train import losses as tlosses
from fast_artistic_videos_tpu_torch.video import driver_vr as tdrv
from fast_artistic_videos_tpu_torch.video import evaluation as tev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TAPS = [idx for idx, *_ in jvgg.VGG16_LAYOUT]


def _tool():
    path = os.path.join(ROOT, "tools", "make_torch_parity_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_parity_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def vgg_path(tool, tmp_path_factory):
    return tool.vgg_npz(tool.EVAL_VGG_SEED, str(tmp_path_factory.mktemp("vgg") / "vgg16.npz"))


@pytest.fixture(scope="module")
def vgg_params(vgg_path):
    return jev.load_vgg_params(vgg_path), tev.load_vgg_params(vgg_path, "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_registry_copy_matches_jax():
    assert treg.CATALOG == {k: treg.StyleEntry(**dataclasses.asdict(v))
                            for k, v in jreg.CATALOG.items()}
    for name in treg.CATALOG:
        assert os.path.samefile(treg.style_fixture(name), jreg.style_fixture(name))
    assert os.path.samefile(treg.bundled_flow_weights(), jreg.bundled_flow_weights())
    with pytest.raises(KeyError):
        treg.style_fixture("nope")
    with pytest.raises(FileNotFoundError, match="fast_artistic_videos_tpu_torch.cli.import_t7"):
        treg.find_converted("candy", models_dir="/nonexistent")


@pytest.mark.parametrize("shape", [(7, 9, 16), (2, 5, 6, 32), (1, 12, 10, 64)])
def test_gram_and_mean_match_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for normalize in (True, False):
        want = np.asarray(jgram.gram_matrix(jnp.asarray(x), normalize))
        got = tgram.gram_matrix(_t(x), normalize).numpy()
        assert got.shape == want.shape and _rel(got, want) <= 1e-5
    want = np.asarray(jgram.mean_aggregate(jnp.asarray(x)))
    assert _rel(tgram.mean_aggregate(_t(x)).numpy(), want) <= 1e-5


def test_gram_scope_restores_the_matmul_flag():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with device_mod.float32_convs():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        tgram.gram_matrix(torch.ones(2, 3, 4))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_extract_features_every_tap_matches_jax(vgg_params):
    jp, tp = vgg_params
    x = (np.random.default_rng(2).random((1, 36, 44, 3)) * 255 - 120).astype(np.float32)
    want = jvgg.extract_features(jp, jnp.asarray(x), TAPS)
    got = tvgg.extract_features(tp, _t(x), TAPS)
    assert sorted(got) == sorted(want) == TAPS
    for tap in TAPS:
        assert got[tap].shape == want[tap].shape, tap
        assert _rel(got[tap].numpy(), want[tap]) <= 1e-4, tap
    # the net stops at the deepest tap, and bad taps raise
    assert set(tvgg.extract_features(tp, _t(x), [4, 9])) == {4, 9}
    with pytest.raises(ValueError, match="invalid VGG tap"):
        tvgg.extract_features(tp, _t(x), [4, 40])


def test_init_params_law():
    p = tvgg.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(p) == [f"conv{idx:02d}" for idx, op, *_ in jvgg.VGG16_LAYOUT if op == "conv"]
    for idx, op, cin, cout in tvgg.VGG16_LAYOUT:
        if op == "conv":
            w = p[f"conv{idx:02d}"]["w"]
            assert tuple(w.shape) == (cout, cin, 3, 3)
            assert float(w.abs().max()) <= 1.0 / (9 * cin) ** 0.5


_LOSS_CASES = [(agg, loss, ext) for ext in ("vgg", "rgb-pyramid")
               for agg in ("gram", "mean") for loss in ("L2", "SmoothL1")]


@pytest.mark.parametrize("agg,loss,extractor", _LOSS_CASES)
def test_style_targets_and_perceptual_loss_match_jax(vgg_params, agg, loss, extractor):
    jp, tp = vgg_params
    rng = np.random.default_rng(3)
    if extractor == "vgg":
        layers = dict(style_layers=(4, 9, 16, 23), style_weights=(10.0, 5.0, 2.0, 1.0),
                      content_layers=(16,), content_weights=(1.0,),
                      deepdream_layers=(9,), deepdream_weights=(1e-3,))
    else:
        layers = dict(style_layers=(0, 1, 2), style_weights=(1.0, 2.0, 3.0),
                      content_layers=(1,), content_weights=(0.5,))
    kw = dict(agg_type=agg, loss_type=loss, extractor=extractor, **layers)
    jcfg, tcfg = jlosses.PerceptualConfig(**kw), tlosses.PerceptualConfig(**kw)
    style, x, content = (((rng.random((n, 36, 44, 3)) * 255) - 120).astype(np.float32)
                         for n in (1, 2, 2))
    jt = jlosses.style_targets(jp, jnp.asarray(style), jcfg)
    tt = tlosses.style_targets(tp, _t(style), tcfg)
    for a, b in zip(tt, jt):
        assert _rel(a.numpy(), b) <= 1e-4
    jtotal, jper = jlosses.perceptual_loss(jp, jnp.asarray(x), jnp.asarray(content), jt, jcfg)
    ttotal, tper = tlosses.perceptual_loss(tp, _t(x), _t(content), tt, tcfg)
    assert sorted(tper) == sorted(jper)
    for k in jper:
        assert _rel(float(tper[k]), float(jper[k])) <= 1e-4, k
    assert _rel(float(ttotal), float(jtotal)) <= 1e-4


@pytest.mark.parametrize("kind", ["L2", "L1", "SmoothL1"])
def test_pixel_loss_matches_jax(kind):
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((2, 9, 11, 3)).astype(np.float32) * 2 for _ in range(2))
    want = float(jlosses.pixel_loss(kind, jnp.asarray(a), jnp.asarray(b)))
    assert _rel(float(tlosses.pixel_loss(kind, _t(a), _t(b))), want) <= 1e-5
    with pytest.raises(ValueError):
        tlosses.pixel_loss("L3", _t(a), _t(b))


@pytest.mark.parametrize("hw,size", [((384, 384), 64), ((40, 60), 17), ((60, 40), 23),
                                     ((20, 30), 50)])
def test_scale_shorter_matches_jax(hw, size):
    img = np.random.default_rng(5).random(hw + (3,)).astype(np.float32)
    want = jev._scale_shorter(img, size)
    got = tev._scale_shorter(_t(img), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def _eval_opts(vgg_path, **kw):
    style = jreg.style_fixture("candy")
    return (JOptions(loss_network=vgg_path, style_image=style, style_image_size=48, **kw),
            TOptions(loss_network=vgg_path, style_image=style, style_image_size=48, **kw))


def test_scorer_matches_jax(vgg_path):
    jo, to = _eval_opts(vgg_path)
    js, ts = jev.PerceptualScorer(jo), tev.PerceptualScorer(to, "cpu")
    rng = np.random.default_rng(6)
    for _ in range(2):
        content, stylized = (rng.random((40, 48, 3)).astype(np.float32) for _ in range(2))
        want = js(content, stylized)
        got = ts(_t(content), _t(stylized))
        assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="--loss_network"):
        tev.PerceptualScorer(TOptions(), "cpu")


def _frames_flow(rng, h=24, w=28):
    prev, cur = (rng.random((h, w, 3)).astype(np.float32) for _ in range(2))
    flow = (rng.standard_normal((h, w, 2)) * 2.5).astype(np.float32)
    cert = (rng.random((h, w)) > 0.3).astype(np.float32)
    return prev, cur, flow, cert


@pytest.mark.parametrize("backward_eval", [False, True])
def test_temporal_error_matches_jax(backward_eval):
    prev, cur, flow, cert = _frames_flow(np.random.default_rng(7))
    want = jev.temporal_error(prev, cur, flow, cert, backward_eval)
    got = tev.temporal_error(_t(prev), _t(cur), _t(flow), _t(cert), backward_eval)
    assert _rel(got, want) <= 1e-5
    # numpy in, the CPU
    assert _rel(tev.temporal_error(prev, cur, flow, cert, backward_eval), want) <= 1e-5


@pytest.mark.parametrize("invert,fix,backward", [(False, False, False), (True, False, False),
                                                 (False, True, False), (True, True, True)])
def test_video_evaluator_options_match_jax(vgg_path, tmp_path, invert, fix, backward):
    """VideoEvaluator with --invert_occlusion_eval, --fix_occlusions_eval and
    --backward_eval against the JAX evaluator, on the same files."""
    rng = np.random.default_rng(8)
    prev, cur, flow, _ = _frames_flow(rng, 44, 52)
    flow[..., 0] += 6.0        # a band that leaves no correspondence
    io.write_flo(str(tmp_path / "backward_2_1.flo"), flow)
    io.write_pgm(str(tmp_path / "reliable_2_1.pgm"),
                 (rng.random((44, 52)) > 0.2).astype(np.uint8) * 255)
    kw = dict(flow_pattern_eval=str(tmp_path / "backward_[%d]_{%d}.flo"),
              occlusions_pattern_eval=str(tmp_path / "reliable_[%d]_{%d}.pgm"),
              invert_occlusion_eval=invert, fix_occlusions_eval=fix, backward_eval=backward)
    jo, to = _eval_opts(vgg_path, **kw)
    content = rng.random((44, 52, 3)).astype(np.float32)
    want = jev.VideoEvaluator(jo)(2, content, cur, prev)
    got = tev.VideoEvaluator(to, "cpu")(2, _t(content), _t(cur), _t(prev))
    assert want[2] > 0
    assert _rel(got, want) <= 1e-4
    assert tev.VideoEvaluator(to, "cpu")(1, _t(content), _t(cur), None)[2] == 0.0


def test_seam_metrics_match_jax():
    rng = np.random.default_rng(9)
    img = rng.random((30, 34, 3)).astype(np.float32)
    img2 = rng.random((30, 34, 3)).astype(np.float32)
    mask = np.zeros((30, 34), np.float32)
    mask[:, 20:] = 1.0
    mask[5:9, 3:11] = 0.5
    for m in (mask, np.zeros_like(mask)):
        want = jev.gradient_ratios(img, m)
        got = tev.gradient_ratios(_t(img), _t(m))
        assert _rel(got, want) <= 1e-5
    for edge in ("left", "top"):
        assert _rel(tev.edge_mse(_t(img), _t(img2), edge), jev.edge_mse(img, img2, edge)) <= 1e-5
    sq, sq2 = img[:, :30], img2[:, :30]      # cube faces are square
    for edge in ("left", "right", "top", "bottom"):
        want = jev.edge_mse_top(sq, sq2, edge)
        assert _rel(tev.edge_mse_top(_t(sq), _t(sq2), edge), want) <= 1e-5
    for bad in (lambda: tev.edge_mse(_t(img), _t(img2), "bottom"),
                lambda: tev.edge_mse_top(_t(img), _t(img2), "middle")):
        with pytest.raises(ValueError):
            bad()
    for a, b in ((img, img2), (img, img), (img[..., 0], img2[..., 0])):
        assert _rel(tev.ssim(_t(a), _t(b)), jev.ssim(a, b)) <= 1e-5


def test_load_vgg_params_npz_and_t7(vgg_path, tmp_path):
    jp, tp = jev.load_vgg_params(vgg_path), tev.load_vgg_params(vgg_path, "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k]["w"].numpy(),
                                      np.asarray(jp[k]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tp[k]["b"].numpy(), np.asarray(jp[k]["b"]))
    # a Torch-layout VGG-16 prefix (conv, relu, conv, relu, pool, conv) as .t7
    rng = np.random.default_rng(10)
    mods = []
    for spec in ((3, 64), None, (64, 64), None, "pool", (64, 128)):
        if spec is None:
            mods.append(jt7.TorchObject("nn.ReLU", {}))
        elif spec == "pool":
            mods.append(jt7.TorchObject("nn.SpatialMaxPooling", {"kW": 2, "kH": 2}))
        else:
            i, o = spec
            mods.append(jt7.TorchObject("nn.SpatialConvolution", {
                "weight": rng.normal(size=(o, i, 3, 3)), "bias": rng.normal(size=o),
                "nInputPlane": i, "nOutputPlane": o,
                "kW": 3, "kH": 3, "dW": 1, "dH": 1, "padW": 1, "padH": 1}))
    path = str(tmp_path / "vgg16.t7")
    jt7.save_t7(path, jt7.TorchObject("nn.Sequential", {"modules": mods}))
    jp, tp = jev.load_vgg_params(path), tev.load_vgg_params(path, "cpu")
    assert sorted(tp) == sorted(jp) == ["conv01", "conv03", "conv06"]
    for k in jp:
        np.testing.assert_array_equal(tp[k]["w"].numpy(),
                                      np.asarray(jp[k]["w"]).transpose(3, 2, 0, 1))
    x = (rng.random((1, 12, 16, 3)) * 255).astype(np.float32)
    want = jvgg.extract_features(jp, jnp.asarray(x), [6])[6]
    assert _rel(tvgg.extract_features(tp, _t(x), [6])[6].numpy(), want) <= 1e-4


# ---------------------------------------------------------------------------
# the committed evaluator fixture (chip_smoke.py phase 12 holds the card to it)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_fixture(tool):
    return (tool.load(tool.OUT_EVAL), tool.load(tool.OUT), tool.load(tool.OUT_VR))


def test_eval_fixture_matches_live_jax_run(tool, eval_fixture, tmp_path):
    fx, demo, vr_fx = eval_fixture
    assert int(fx["vgg_seed"]) == tool.EVAL_VGG_SEED
    vgg = tool.vgg_npz(int(fx["vgg_seed"]), str(tmp_path / "vgg16.npz"))
    rows_2d, rows_vr = tool.jax_eval_rows(demo, vr_fx, str(tmp_path), vgg)
    assert rows_2d.shape == fx["rows_2d"].shape == (len(demo["frames"]), 3)
    assert rows_vr.shape == fx["rows_vr"].shape == (6 * len(vr_fx["faces"]), 7)
    np.testing.assert_allclose(rows_2d, fx["rows_2d"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(rows_vr, fx["rows_vr"], rtol=1e-6, atol=1e-9)
    # every VR metric takes a non-zero value somewhere
    assert (np.abs(rows_vr).max(axis=0) > 0).all()


def port_eval_rows(tool, demo, vr_fx, workdir, vgg, device):
    """The port's evaluators on the fixture's cases (the CPU test's and
    chip_smoke.py's phase 12's computation)."""
    style = treg.style_fixture("candy")
    n, h, w = demo["frames"].shape[:3]
    pats = tool.write_pan_flow(workdir, n, h, w, tuple(int(v) for v in demo["step"]))
    ev = tev.VideoEvaluator(TOptions(**tool.eval_options(vgg, style, *pats)), device)
    cases_2d, cases_vr = tool.eval_cases(demo, vr_fx)

    def dev(a):
        return None if a is None else _t(a).to(device)
    rows_2d = [ev(i, dev(c), dev(s), dev(p)) for i, c, s, p in cases_2d]
    nv, _, face = vr_fx["faces"].shape[:3]
    overlap = int(vr_fx["overlap"])
    vdir = os.path.join(workdir, "vr")
    os.makedirs(vdir, exist_ok=True)
    vpats = tool.write_pan_flow(vdir, nv, face, face, tuple(int(v) for v in vr_fx["step"]),
                                faces=range(1, 7))
    vopt = tdrv.VROptions(overlap_pixel_w=overlap, overlap_pixel_h=overlap,
                          **tool.eval_options(vgg, style, *vpats))
    vev = tev.VREvaluator(vopt, device)
    geo = tdrv._Geometry(face, face, vopt, device)
    rows_vr = []
    for i, _, segs, prev, content in cases_vr:
        driver = types.SimpleNamespace(geo=geo, segments=[dev(s) for s in segs],
                                       prev_segments=[dev(s) for s in prev],
                                       last_content=dev(content))
        rows_vr.append(vev(driver, i))
    return np.asarray(rows_2d), np.asarray(rows_vr)


def test_port_matches_eval_fixture(tool, eval_fixture, tmp_path):
    fx, demo, vr_fx = eval_fixture
    vgg = tool.vgg_npz(int(fx["vgg_seed"]), str(tmp_path / "vgg16.npz"))
    rows_2d, rows_vr = port_eval_rows(tool, demo, vr_fx, str(tmp_path), vgg, "cpu")
    np.testing.assert_allclose(rows_2d, fx["rows_2d"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(rows_vr, fx["rows_vr"], rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the CLI: --evaluate end to end, port against JAX
# ---------------------------------------------------------------------------

def _eval_file(path):
    lines = open(path).read().strip().split("\n")
    n = len(lines) // 2
    series = [[float(v) for v in line.split(";")] for line in lines[:n]]
    means = [float(v) for v in lines[n:]]
    return np.asarray(series), np.asarray(means)


def test_cli_evaluate_matches_jax(tool, vgg_path, tmp_path):
    """Both CLIs on the demo fixture's first 4 frames, stylized and scored
    with the pan's ground-truth flow and certainty: the same series and
    means within 1e-3 relative."""
    with np.load(os.path.join(FIXTURES, "torch_parity_demo.npz")) as z:
        frames, step = z["frames"][:4], tuple(int(v) for v in z["step"])
    for t, f in enumerate(frames, 1):
        io.write_ppm(str(tmp_path / f"frame_{t:05d}.ppm"), f)
    flow_pat, cert_pat = tool.write_pan_flow(str(tmp_path), len(frames), *frames.shape[1:3],
                                             step)
    args = ["--input_pattern", str(tmp_path / "frame_%05d.ppm"), "--model_vid", "demo",
            "--flow_pattern", flow_pat, "--occlusions_pattern", cert_pat,
            "--num_frames", str(len(frames)), "--evaluate", "--loss_network", vgg_path,
            "--style_image", jreg.style_fixture("candy"), "--style_image_size", "64",
            "--flow_pattern_eval", flow_pat, "--occlusions_pattern_eval", cert_pat]
    jcli.main(args + ["--output_prefix", str(tmp_path / "j" / "o"),
                      "--evaluation_file", str(tmp_path / "j.txt")])
    tcli.main(args + ["--output_prefix", str(tmp_path / "t" / "o"),
                      "--evaluation_file", str(tmp_path / "t.txt"), "--device", "cpu"])
    js, jm = _eval_file(str(tmp_path / "j.txt"))
    ts, tm = _eval_file(str(tmp_path / "t.txt"))
    assert ts.shape == js.shape == (3, len(frames))
    assert ts[2, 0] == 0.0 and (ts[2, 1:] > 0).all()
    np.testing.assert_allclose(ts, js, rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(tm, jm, rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(tm, ts.mean(axis=1), rtol=1e-12)


def test_video_driver_eval_rows_are_device_tensors(vgg_path, tmp_path):
    """The driver hands the evaluator tensors (content in [0, 1], the
    stylized frame and the previous one kept as a tensor, not a host copy)."""
    from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver
    from fast_artistic_videos_tpu_torch.video.engine import EngineConfig, StylizerEngine

    rng = np.random.default_rng(11)
    for t in (1, 2, 3):
        io.write_ppm(str(tmp_path / f"frame_{t:05d}.ppm"),
                     (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    opt = TOptions(input_pattern=str(tmp_path / "frame_%05d.ppm"), num_frames=3,
                   create_inconsistent=True, output_prefix=str(tmp_path / "o" / "o"),
                   evaluation_file=str(tmp_path / "e.txt"))
    seen = []

    def eval_fn(i, content, stylized, prev):
        seen.append((i, content, stylized, prev))
        return [float(i), float(content.mean())]
    engine = StylizerEngine(lambda p, x: x[..., 0:3], None, config=EngineConfig(),
                            device="cpu")
    VideoDriver(engine, opt, eval_fn=eval_fn).run(progress=False)
    assert [s[0] for s in seen] == [1, 2, 3]
    assert seen[0][3] is None and seen[1][3] is seen[0][2] and seen[2][3] is seen[1][2]
    assert all(torch.is_tensor(c) and c.dtype == torch.float32 and float(c.max()) <= 1.0
               for _, c, _, _ in seen)
    series, means = _eval_file(str(tmp_path / "e.txt"))
    np.testing.assert_array_equal(series[0], [1.0, 2.0, 3.0])
    assert means[0] == 2.0
