"""The port's multi-card paths on the card (``gpu`` marker; they skip
without a card, the two-card ones on one card). This file imports no jax:
on the card host run it alone,

  python -m pytest --noconftest -m gpu tests/test_torch_multicard_gpu.py

  * flow.provider._LateScalar records its event on the stream of the
    tensor's card: a copy queued behind a delay kernel on the last card,
    card 0 current, reads the value a synchronous read gives; so does the
    streaming provider's band;
  * video.serving.StreamPool: every stream's launches take its own card
    (each kernel launch recorded with its device), its output lives there,
    and it agrees with a solo engine and provider on that card: float32
    within max abs 1e-3 of the [0, 1] range; bfloat16 within a mean-abs
    of 1e-3 a frame and a max abs of two bfloat16 steps of an output in
    [0.5, 1] (2 x 2^-8): K2's and K3's statistics are float32 atomics, so
    two bfloat16 runs of one stream differ by such steps (chip_smoke.py
    phase 17 measured 2^-7 between two solo runs, and between the pool
    and the solo runs, on H100 80GB HBM3 cards at 700 W).
"""

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.flow import estimator
from fast_artistic_videos_tpu_torch.flow.provider import StreamingFlowProvider, _LateScalar
from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer
from fast_artistic_videos_tpu_torch.ops import _build
from fast_artistic_videos_tpu_torch.video.engine import EngineConfig, StylizerEngine
from fast_artistic_videos_tpu_torch.video.serving import StreamPool

pytestmark = pytest.mark.gpu

DELAY_CYCLES = 200_000_000      # about 0.1 s of the card's clock
BF16_MAX_ABS = 2 * 2.0 ** -8    # two bfloat16 steps of an output in [0.5, 1]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.device_count()


def _delay(dev):
    """Queue a spinning kernel on `dev`'s current stream."""
    with torch.cuda.device(dev):
        torch.cuda._sleep(DELAY_CYCLES)


def test_late_scalar_waits_for_the_copy_on_the_tensors_card(cards):
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", cards - 1)
    assert torch.cuda.current_device() == 0
    for i in range(5):
        x = torch.full((1024,), float(i + 1), device=dev)
        _delay(dev)
        t = (x * 3).sum()           # produced behind the delay, on card dev
        late = _LateScalar(t)       # card 0 is current
        assert late.get() == float(t) == 3072.0 * (i + 1)
    assert torch.cuda.current_device() == 0


def test_provider_band_on_another_card(cards):
    """The band that sizes each warp comes from the previous pair's late
    read: a provider on the last card with card 0 current, each pair queued
    behind a delay kernel, gives the bands of a provider whose every read
    waits for the card."""
    if cards < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", cards - 1)
    params = estimator.load_params("bundled", dev)
    rng = np.random.default_rng(3)
    base = rng.random((96, 160 + 6 * 8, 3)).astype(np.float32)
    frames = [torch.from_numpy(np.ascontiguousarray(base[:, 6 * t:6 * t + 160])).to(dev)
              for t in range(8)]
    bands = {}
    for mode in ("late", "synced"):
        prov = StreamingFlowProvider(params, device=dev, flow_scale=0.5)
        bands[mode] = []
        for f in frames:
            if mode == "late":
                _delay(dev)
            else:
                torch.cuda.synchronize(dev)
            out = prov(f)
            if out is not None:
                assert out[0].device == dev and out[1].device == dev
                bands[mode].append(prov.last_band)
    assert bands["late"] == bands["synced"]
    assert torch.cuda.current_device() == 0


@pytest.fixture
def launch_devices(monkeypatch):
    """Every kernel launch's (kernel, card) in order."""
    seen = []
    call = _build.Kernel.call

    def recording(self, name, device, *args):
        seen.append((self.name, device.index))
        return call(self, name, device, *args)
    monkeypatch.setattr(_build.Kernel, "call", recording)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_pool_launches_on_each_streams_card(cards, launch_devices, dtype):
    """2 x cards streams of the demo model with streaming flow, round-robin
    over every card: each stream-frame's launches (K1 in the flow and the
    prior warp, K3 and K2 in the stylizer) take the stream's card, its
    output lives there and agrees with a solo engine and provider on that
    card (see the module docstring for the bars)."""
    spec, params, _ = checkpoint.load_model("demo", "cuda:0")
    fparams = estimator.load_params("bundled", "cuda:0")
    n = 2 * cards
    pool = StreamPool(spec, params, flow_params=fparams, n_streams=n, dtype=dtype,
                      flow_scale=0.5)
    rng = np.random.default_rng(4)
    clips = []
    for s in range(n):
        base = (rng.random((128, 192 + 4 * 4, 3)) * 255).astype(np.uint8)
        clips.append([np.ascontiguousarray(base[:, 4 * t:4 * t + 192]) for t in range(4)])
    outs = {s: [] for s in range(n)}
    for t in range(4):
        for s in range(n):
            del launch_devices[:]
            out = pool.process(s, clips[s][t])
            card = s % cards
            assert pool.device_of(s) == torch.device("cuda", card)
            assert out.device == torch.device("cuda", card)
            names = {k for k, _ in launch_devices}
            assert {d for _, d in launch_devices} == {card}, launch_devices
            want = {"front_conv", "res_chain_conv"} | ({"warp_banded"} if t else set())
            assert want <= names, names
            outs[s].append(out)
    assert torch.cuda.current_device() == 0
    for s in range(n):
        dev = torch.device("cuda", s % cards)
        eng = StylizerEngine(lambda p, x: stylizer.apply(p, spec, x),
                             stylizer.to_device(params, dev), stride_multiple=spec.total_stride,
                             config=EngineConfig(dtype=dtype), device=dev)
        prov = StreamingFlowProvider(
            flow_estimator=estimator.FlowEstimator(
                stylizer.to_device(fparams, dev),
                dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32, device=dev),
            flow_scale=0.5)
        prev = None
        for t, f in enumerate(clips[s]):
            frame = torch.from_numpy(f).to(dev)
            fc = prov(frame)
            prev = (eng.stylize_first(frame) if fc is None else
                    eng.stylize_next(frame, prev, fc[0], fc[1], prov.last_band))
            d = (outs[s][t] - prev).abs()
            if dtype == "float32":
                assert d.max().item() <= 1e-3
            else:
                assert d.mean().item() <= 1e-3 and d.max().item() <= BF16_MAX_ABS
