"""The port's multi-stream serving (fast_artistic_videos_tpu_torch:
video.serving.StreamPool, cli.serve_streams) on the CPU, against the JAX
package's (tests/test_serving.py):

  * three streams of the demo model with the bundled flow estimator
    (streaming flow, 48x64 frames, float32) round-robin over ["cpu", "cpu"],
    one of them reset mid-clip, against the JAX package's StreamPool on two
    virtual CPU devices: every frame within a mean-abs of 1e-2 (BASELINE's
    bar); the reset stream restarts as its first frame did;
  * the pool's streams against the port's solo engine on the same clips
    (flow and certainty passed in): atol 1e-5;
  * the CLI with --device cpu against the same JAX pool run, and the
    device checks of the pool's entry points.
"""

import jax
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.flow import estimator as jfest
from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import registry as jregistry
from fast_artistic_videos_tpu.video.serving import StreamPool as JaxStreamPool
from fast_artistic_videos_tpu_torch.cli import serve_streams
from fast_artistic_videos_tpu_torch.core import io
from fast_artistic_videos_tpu_torch.flow import estimator as tfest
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.video.engine import EngineConfig, StylizerEngine
from fast_artistic_videos_tpu_torch.video.serving import StreamPool

H, W, FRAMES, STREAMS = 48, 64, 3, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this process: the suite runs several workers on
    the host's cores, and torch's thread pools on every core of every
    worker slow the small ops here by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def clip(s):
    """Stream s: FRAMES frames of a seeded image panning 2 px a frame."""
    base = np.random.default_rng(10 + s).random((H, W + 2 * FRAMES, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, 2 * t:2 * t + W]) for t in range(FRAMES)]


# the feed: every stream's frames in turn, then stream 0 reset and fed its
# first two frames again
FEED = ([(s, t) for t in range(FRAMES) for s in range(STREAMS)]
        + [("reset", 0), (0, 0), (0, 1)])


def drive(pool):
    clips = {s: clip(s) for s in range(STREAMS)}
    outs = []
    for s, t in FEED:
        if s == "reset":
            pool.reset(t)
            continue
        outs.append(np.asarray(pool.process(s, clips[s][t])))
    return outs


@pytest.fixture(scope="module")
def jax_outs():
    spec, params, _ = jckpt.load_model("demo")
    pool = JaxStreamPool(spec, params,
                         flow_params=jfest.load_params(jregistry.bundled_flow_weights()),
                         n_streams=STREAMS, devices=jax.devices()[:2], dtype="float32")
    return drive(pool)


@pytest.fixture(scope="module")
def port_model():
    spec, params, _ = tckpt.load_model("demo", device="cpu")
    return spec, params, tfest.load_params("bundled", device="cpu")


def test_pool_matches_jax_pool(port_model, jax_outs):
    spec, params, fparams = port_model
    pool = StreamPool(spec, params, flow_params=fparams, n_streams=STREAMS,
                      devices=["cpu", "cpu"], dtype="float32")
    outs = drive(pool)
    assert [pool.device_of(s) for s in range(STREAMS)] == [torch.device("cpu")] * STREAMS
    for i, ((s, t), a, b) in enumerate(zip([f for f in FEED if f[0] != "reset"], outs,
                                           jax_outs)):
        assert a.shape == (H, W, 3) and np.isfinite(a).all()
        assert np.abs(a - b).mean() <= 1e-2, (i, s, t, np.abs(a - b).mean())
    # stream 0 after its reset restarts as a new clip
    np.testing.assert_array_equal(outs[-2], outs[0])
    np.testing.assert_array_equal(outs[-1], outs[STREAMS])


def test_pool_streams_match_solo_engine(port_model):
    """Pooling changes placement, not math: each stream equals a solo
    engine run of its clip (flow and certainty from the caller)."""
    spec, params, _ = port_model
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = -2.0
    cert = np.ones((H, W), np.float32)
    cert[:, :2] = 0.0
    pool = StreamPool(spec, params, n_streams=STREAMS, devices=["cpu", "cpu"],
                      dtype="float32")
    clips = {s: clip(s) for s in range(STREAMS)}
    outs = {s: [] for s in range(STREAMS)}
    for t in range(FRAMES):
        for s in range(STREAMS):
            outs[s].append(pool.process(s, clips[s][t], None if t == 0 else (flow, cert)))
    eng = StylizerEngine(lambda p, x: tsty.apply(p, spec, x), params,
                         stride_multiple=spec.total_stride,
                         config=EngineConfig(dtype="float32"), device="cpu")
    for s, frames in clips.items():
        prev = None
        for t, f in enumerate(frames):
            prev = (eng.stylize_first(f) if t == 0 else
                    eng.stylize_next(f, prev, torch.from_numpy(flow), torch.from_numpy(cert)))
            torch.testing.assert_close(outs[s][t], prev, rtol=0, atol=1e-5)


def test_pool_pins_streams_round_robin(port_model):
    """Stream i lives on devices[i % N]; its output is on that device."""
    spec, params, _ = port_model
    devices = [torch.device("cpu")] * 2
    pool = StreamPool(spec, params, n_streams=3, devices=devices, dtype="float32")
    for s in range(3):
        assert pool.device_of(s) == devices[s % 2]
        assert pool.process(s, clip(s)[0]).device == devices[s % 2]
    with pytest.raises(ValueError, match="n_streams"):
        StreamPool(spec, params, n_streams=0, devices=devices)


def test_pool_raises_without_a_card(port_model):
    spec, params, _ = port_model
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamPool(spec, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_streams.main(["--model_vid", "demo", "--flow_model", "bundled",
                            "--inputs", "x_%05d.ppm"])


def test_serve_streams_cli_matches_jax_pool(tmp_path, jax_outs):
    """Three clips in, per-stream PNGs out, bundled demo model and flow,
    float32 on the CPU; each frame within a mean-abs of 1e-2 of the JAX
    pool's (the CLI feeds frame t of every stream in turn, as FEED does)."""
    pats = []
    for s in range(STREAMS):
        d = tmp_path / f"clip{s}"
        d.mkdir()
        for t, f in enumerate(clip(s), 1):
            io.save_image(str(d / f"frame_{t:05d}.ppm"), f)
        pats.append(str(d / "frame_%05d.ppm"))
    out = tmp_path / "out"
    assert serve_streams.main(["--model_vid", "demo", "--flow_model", "bundled",
                               "--inputs", ",".join(pats), "--output_dir", str(out),
                               "--dtype", "float32", "--device", "cpu"]) == 0
    for i, (s, t) in enumerate([f for f in FEED if f[0] != "reset"][:STREAMS * FRAMES]):
        img = io.load_image(str(out / f"stream{s}-{t + 1:05d}.png"))
        assert img.shape == (H, W, 3)
        assert np.abs(img - jax_outs[i]).mean() <= 1e-2, (s, t)
