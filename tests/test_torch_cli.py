"""The port's CLI (fast_artistic_videos_tpu_torch.cli.stylize_video) against
the JAX package's CLI on the same seeded PPM pan, with the zero-download
path (--model_vid demo --flow_model bundled --flow_scale 0.5, float32, on
the CPU). Each frame agrees within a mean-abs of 1e-2 (of the [0, 1]
range). The committed fixture (tools/make_torch_parity_fixture.py) is
checked against a live JAX run first, within one uint8 step."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu_torch.cli import stylize_video as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parity_demo.npz")


def _tool():
    path = os.path.join(ROOT, "tools", "make_torch_parity_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_parity_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _write_frames(frames, d):
    for t, f in enumerate(frames, 1):
        io.write_ppm(os.path.join(d, f"frame_{t:05d}.ppm"), f)
    return os.path.join(d, "frame_%05d.ppm")


def _port_cli(pattern, prefix, *extra):
    tcli.main(["--input_pattern", pattern, "--model_vid", "demo",
               "--flow_model", "bundled", "--flow_scale", "0.5",
               "--output_prefix", prefix, "--device", "cpu", *extra])


def _read(prefix, idxs):
    return np.stack([io.load_image_u8(f"{prefix}-{t:05d}.png") for t in idxs])


def _mean_abs(a, b):
    return np.abs(a.astype(np.float32) - b.astype(np.float32)).mean(axis=(1, 2, 3)) / 255.0


def test_fixture_matches_live_jax_run(fixture, tmp_path):
    tool = _tool()
    frames = tool.pan_frames(int(fixture["seed"]), *fixture["frames"].shape[:3],
                             step=tuple(int(v) for v in fixture["step"]))
    np.testing.assert_array_equal(frames, fixture["frames"])
    live = tool.run_jax_cli(frames, str(tmp_path))
    assert np.abs(live.astype(int) - fixture["outputs"].astype(int)).max() <= 1


def test_port_cli_matches_jax_cli(fixture, tmp_path):
    frames, want = fixture["frames"], fixture["outputs"]
    prefix = os.path.join(tmp_path, "out", "o")
    _port_cli(_write_frames(frames, str(tmp_path)), prefix)
    got = _read(prefix, range(1, len(frames) + 1))
    assert got.shape == want.shape
    err = _mean_abs(got, want)
    assert (err <= 1e-2).all(), err


def test_port_cli_resume(fixture, tmp_path):
    """--continue_with 3 after frames 1-2: the provider is primed with
    frame 2, the recurrence restarts from the written frame 2, and frames
    3.. still agree with the uninterrupted JAX run."""
    frames, want = fixture["frames"], fixture["outputs"]
    pattern = _write_frames(frames, str(tmp_path))
    prefix = os.path.join(tmp_path, "out", "o")
    _port_cli(pattern, prefix, "--num_frames", "2")
    _port_cli(pattern, prefix, "--continue_with", "3")
    got = _read(prefix, range(1, len(frames) + 1))
    err = _mean_abs(got, want)
    assert (err <= 1e-2).all(), err


def test_file_pattern_flow_mode_matches_jax_cli(fixture, tmp_path):
    """Flow and certainty from .flo/.pgm files named by the pattern DSL
    (the exact pan flow, a certainty hole, --fix_occlusions)."""
    from fast_artistic_videos_tpu.cli import stylize_video as jcli

    frames = fixture["frames"][:3]
    pattern = _write_frames(frames, str(tmp_path))
    dx, dy = (float(v) for v in fixture["step"])
    h, w = frames.shape[1:3]
    for t in range(2, len(frames) + 1):
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0], flow[..., 1] = dx, dy
        cert = np.full((h, w), 255, np.uint8)
        cert[20:40, 30:60] = 0
        io.write_flo(os.path.join(tmp_path, f"backward_{t}_{t - 1}.flo"), flow)
        io.write_pgm(os.path.join(tmp_path, f"reliable_{t}_{t - 1}.pgm"), cert)
    args = ["--input_pattern", pattern, "--model_vid", "demo", "--fix_occlusions",
            "--flow_pattern", os.path.join(tmp_path, "backward_[%d]_{%d}.flo"),
            "--occlusions_pattern", os.path.join(tmp_path, "reliable_[%d]_{%d}.pgm")]
    jcli.main(args + ["--output_prefix", os.path.join(tmp_path, "j", "o")])
    tcli.main(args + ["--output_prefix", os.path.join(tmp_path, "t", "o"), "--device", "cpu"])
    idxs = range(1, len(frames) + 1)
    err = _mean_abs(_read(os.path.join(tmp_path, "t", "o"), idxs),
                    _read(os.path.join(tmp_path, "j", "o"), idxs))
    assert (err <= 1e-2).all(), err


def test_unported_options_raise(tmp_path):
    """Every flag of the JAX CLI is carried since the evaluation slice
    (--evaluate: tests/test_torch_evaluation.py); --evaluate without a loss
    network raises before any frame is stylized, naming the flag."""
    for extra in (["--evaluate"],):
        with pytest.raises(ValueError, match="--loss_network"):
            _port_cli(os.path.join(tmp_path, "f_%05d.ppm"), str(tmp_path), *extra)


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--input_pattern", os.path.join(tmp_path, "f_%05d.ppm"),
                   "--model_vid", "demo", "--create_inconsistent"])


def _entry_points():
    """Each library entry point that places tensors, called without a
    device (the parameters it is handed live on the CPU)."""
    from fast_artistic_videos_tpu_torch.flow import estimator, provider
    from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer
    from fast_artistic_videos_tpu_torch.video.engine import StylizerEngine

    spec, params, _ = checkpoint.load_model("demo", device="cpu")
    fparams = estimator.load_params("bundled", device="cpu")
    return {
        "StylizerEngine": lambda: StylizerEngine(lambda p, x: x, params),
        "FlowEstimator": lambda: estimator.FlowEstimator(fparams),
        "load_params": lambda: estimator.load_params("bundled"),
        "StreamingFlowProvider": lambda: provider.StreamingFlowProvider(fparams),
        "BatchedStreamingFlowProvider": lambda: provider.BatchedStreamingFlowProvider(fparams),
        "load_model": lambda: checkpoint.load_model("demo"),
        "params_from_numpy": lambda: checkpoint.params_from_numpy({"b": np.zeros(3)}),
        "init_params": lambda: stylizer.init_params(torch.Generator(), spec),
    }


@pytest.mark.parametrize("name", ["StylizerEngine", "FlowEstimator", "load_params",
                                  "StreamingFlowProvider", "BatchedStreamingFlowProvider",
                                  "load_model", "params_from_numpy", "init_params"])
def test_entry_points_default_to_the_card(name):
    """Library entry points run on the card unless asked for the CPU: on a
    host without one the default raises and names device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        _entry_points()[name]()


def test_flow_device_past_the_card_count_is_not_pinned(monkeypatch):
    """--flow_device pins the flow stage to card N only when 0 <= N < the
    card count, as the JAX CLI does; otherwise the stage stays on the run's
    device (on a one-card host, --flow_device 1 used to raise)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    assert tcli.flow_stage_device(1, cuda) == cuda
    assert tcli.flow_stage_device(5, torch.device("cuda", 0)) == torch.device("cuda", 0)
    assert tcli.flow_stage_device(0, cuda) == torch.device("cuda", 0)
    assert tcli.flow_stage_device(-1, cuda) == cuda
    assert tcli.flow_stage_device(0, torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tcli.flow_stage_device(3, cuda) == torch.device("cuda", 3)
