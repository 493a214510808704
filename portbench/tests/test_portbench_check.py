"""The check that decides ``correct``, on the CPU at a size a test holds:
the reference against the port's plain path, whole runs of each entry
(sound: correct; the bfloat16 control and planted faults: not correct),
and the result line's keys. The harness's look for a card is skipped:
``run_cell`` is handed CPU devices."""

import copy
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import spec, weights  # noqa: E402
from portbench.harness.main import run_cell  # noqa: E402
from portbench.reference import flow as flow_ref  # noqa: E402
from portbench.reference import flow_pwclite  # noqa: E402
from portbench.reference import stylizer as net_ref  # noqa: E402

FLOW = os.path.join(ROOT, "fast_artistic_videos_tpu", "assets", "flow_pwclite.npz")
SEED = 2 ** 31 + 4242


def _tiny(name):
    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    if cell.config["geometry"]["kind"] == "cube_faces":
        cell.config["geometry"].update(face=70, overlap=24)
    else:
        cell.config["geometry"].update(height=64, width=96)
    cell.traffic["check"]["every"] = 2
    if cell.traffic["entry"] == "stream_pool":
        cell.traffic["streams"] = 3
        cell.traffic["check"]["streams"] = 2
    return cell


def _run(name, seconds=2.0, **kw):
    torch.set_num_threads(2)
    cell = _tiny(name)
    devices = [torch.device("cpu")] * (2 if cell.traffic["entry"] == "stream_pool" else 1)
    return run_cell(cell, SEED, seconds, False, devices, time.monotonic(), **kw)


def test_the_reference_net_is_the_ports_plain_forward():
    from fast_artistic_videos_tpu_torch.models import stylizer
    from fast_artistic_videos_tpu_torch.models.arch_dsl import parse_arch

    cfg = spec.cell("canonical-1080p.clip").config
    net = net_ref.parse(cfg["arch"])
    params = weights.draw(net, SEED, "cpu")
    port_spec = parse_arch(cfg["arch"])
    assert port_spec.input_pad == net.input_pad and port_spec.total_stride == net.total_stride
    x = torch.randn(1, 48, 64, 7, generator=torch.Generator().manual_seed(1)) * 50
    want = net_ref.forward(params, net, x)
    for fused in (False, True):
        got = stylizer.apply(params, port_spec, x, fused=fused)
        assert torch.allclose(got, want, atol=2e-3, rtol=1e-4), (got - want).abs().max()


def test_the_reference_flow_is_the_ports_streaming_provider():
    from fast_artistic_videos_tpu_torch.flow import estimator
    from fast_artistic_videos_tpu_torch.flow.provider import StreamingFlowProvider
    from portbench.harness import frames

    pan = frames.Source(SEED, 96, period=256).pans(1, 64, 96, (6, 3))[0]
    prov = StreamingFlowProvider(estimator.load_params(FLOW, "cpu"), device="cpu",
                                 flow_scale=0.5, erode_window=7)
    ref = flow_ref.StreamingFlow(flow_pwclite, flow_ref.load_weights(FLOW, "cpu"), 0.5, erode=7)
    for t in range(4):
        f = torch.from_numpy(np.ascontiguousarray(pan.frame(t)))
        got, want = prov(f), ref(f[None])
        if t == 0:
            assert got is None and want is None
            continue
        assert torch.allclose(got[0], want[0][0], atol=1e-4)
        assert torch.equal(got[1], want[1][0])
        assert prov.last_band == want[2]


@pytest.mark.parametrize("name", ["canonical-1080p.clip", "canonical-vr922.clip",
                                  "canonical-1080p.serve8"])
def test_a_sound_run_of_each_entry_is_correct(name):
    result, faults = _run(name)
    assert faults == []
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 3 and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) <= {"setup_s", "frames_per_s", "frame_latency_ms_p95"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(result)


def test_the_bfloat16_control_is_not_correct():
    result, _ = _run("canonical-1080p.clip", dtype="bfloat16")
    assert result["correct"] is False
    lim = spec.limits("canonical-1080p.clip")
    assert any(result["checks"][n]["value"] > lim[n]["limit"] for n in lim if n in result["checks"])


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from fast_artistic_videos_tpu_torch.video import engine

    def stale(self, content, prev_stylized, flow, cert, band_hint=None, emit_u8=False,
              pre_eroded=False):
        prev = prev_stylized.float()
        return (prev, engine.quantize_u8(prev)) if emit_u8 else prev

    monkeypatch.setattr(engine.StylizerEngine, "stylize_next", stale)
    for name in ("canonical-1080p.clip", "canonical-1080p.serve8"):
        result, _ = _run(name)
        assert result["correct"] is False


def test_an_output_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from fast_artistic_videos_tpu_torch.video import engine

    real = engine.quantize_u8

    def altered(y):
        q = real(y).clone()
        q[:8, :8] = 255 - q[:8, :8]
        return q

    monkeypatch.setattr(engine, "quantize_u8", altered)
    for name in ("canonical-1080p.clip", "canonical-1080p.serve8"):
        result, _ = _run(name)
        assert result["correct"] is False


def test_faces_left_unblended_are_not_correct(monkeypatch):
    from fast_artistic_videos_tpu_torch.video import driver_vr

    monkeypatch.setattr(driver_vr.VRDriver, "blend_other_sides", lambda self: list(self.segments))
    result, _ = _run("canonical-vr922.clip")
    assert result["correct"] is False


@pytest.mark.gpu
def test_the_control_fails_on_the_card_at_the_cells_own_size():
    """On the card (``python -m pytest -m gpu portbench/tests``): the
    program at the clip cell's own size on three seeds is correct, its
    bfloat16 control on the same seeds is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell("canonical-1080p.clip")
    for seed in (SEED, SEED + 1, SEED + 2):
        ok, _ = run_cell(cell, seed, 4.0, False, [torch.device("cuda", 0)], time.monotonic())
        ctl, _ = run_cell(cell, seed, 4.0, False, [torch.device("cuda", 0)], time.monotonic(),
                          dtype="bfloat16")
        assert ok["correct"] is True and ctl["correct"] is False
