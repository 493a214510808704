"""The FlowNet 2.0 configuration's benchmark files on the CPU: the family's
draw, save and load (``reference/flow_flownet2.py``) and the program reading
what ``save`` wrote (``flows/flownet2.py``); the operation count at 1080p
and flow scale 0.5 (1.119 TFLOP a frame, both directions); K7's work count
(``kernels/correlation_f32.py``) and its symbol; the cell's per-layer
metrics (the canonical clip's and K7's two), and the readers of the flow's
device time, the step's share of the peak and K7's on a synthetic trace;
nothing counted for a program without K7; and the cell run through
``run_cell`` at a small frame size."""

import importlib.util
import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fast_artistic_videos_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import spec, tracing, work  # noqa: E402
from portbench.harness.main import Context, run_cell  # noqa: E402
from portbench.reference import stylizer as net_ref  # noqa: E402

SEED = 2 ** 31 + 6161
CELL = "flownet2-1080p.clip"
MS = 1_000_000


@pytest.fixture(scope="module")
def family():
    return spec.flow_reference("flownet2")


def test_the_cell_names_the_family_and_its_files():
    cell = spec.cell(CELL)
    assert spec.flow_model(cell.config) == "flownet2"
    assert cell.config["flow"] == {"model": "flownet2", "weights": "seed", "scale": 0.5}
    assert cell.config["reduced"] == []
    # the metrics of the layers the canonical clip shares with it, and K7's
    assert {m["name"] for m in cell.per_layer} == {
        "flow.device_ms", "stylizer.device_ms", "kernels_roofline", "device.idle_share",
        "step.mfu", "frame.latency_ms_p95", "driver.wait_ms", "flow.host_ms",
        "engine.host_ms", "stylizer.host_ms", "kernels.host_us", "upsample_conv.device_ms",
        "upsample_conv.launches", "upsample_conv.roofline", "correlation.roofline",
        "correlation.launches"}
    assert spec.limits(CELL) is not None


def test_draw_save_load_and_the_program_reads_it(family, tmp_path):
    drawn = family.draw(SEED, "cpu")
    assert sum(t.numel() for v in drawn.values() for t in v.values()) == 162_518_818
    other = family.draw(SEED + 1, "cpu")
    assert not torch.equal(drawn["flownetc.conv1"]["w"], other["flownetc.conv1"]["w"])
    del other
    path = str(tmp_path / "flow.npz")
    family.save(path, drawn)
    back = family.load(path, "cpu")
    read = spec.flow_program("flownet2").program_params(path, "cpu")
    for name, leaves in drawn.items():
        for leaf, t in leaves.items():
            assert torch.equal(back[name][leaf], t) and torch.equal(read[name][leaf], t)
    from fast_artistic_videos_tpu_torch.flow import family as program_family

    assert program_family.family(read) == "flownet2"


def test_operations_of_a_1080p_frame(family):
    """1.119 TFLOP for one new 1080p frame at flow scale 0.5, both
    directions, every layer of each (the correlation's multiply-adds
    included); with the canonical stylizer, the cell's step."""
    like = {name: {"w": torch.empty(family._shape(kind, k, ci, co), device="meta"),
                   **({} if kind == "up" else {"b": torch.empty(co, device="meta")})}
            for name, kind, k, ci, co in family.layers()}
    flops = family.flops(like, (1080, 1920), 1, 0.5)
    assert flops == pytest.approx(1.119e12, rel=0.01)
    corr = 2 * 2 * 441 * 256 * 72 * 120
    assert corr == pytest.approx(3.9e9, rel=0.01)
    cfg = spec.cell(CELL).config
    net = net_ref.parse(cfg["arch"], int(cfg["in_channels"]))
    step = work.model_flops(net, _like(net), family, like, (1080, 1920), 1, 0.5)
    assert 1.7e12 < step < 1.9e12 and step - flops > 0.6e12


def _like(net):
    from portbench.harness import weights

    like = {}
    for name, shape, _ in net_ref.param_shapes(net):
        weights.tree_set(like, name, torch.empty(shape, device="meta"))
    return like


def test_k7_counts_its_work_and_is_not_counted_without_k7(monkeypatch):
    k7 = spec.kernels()["correlation_f32"]
    [(owner, attr, count)] = k7.ENTRIES
    assert (owner, attr) == ("fast_artistic_videos_tpu_torch.ops.correlation_kernel",
                             "correlation")
    maps = torch.empty((2, 256, 72, 120), device="meta")
    flops, nbytes, dtype = count(None, maps, maps, b_shift=1)
    assert (flops, dtype) == (2 * 441 * 256 * 2 * 72 * 120, "float32")
    assert nbytes == 4 * (2 * 256 * 8640 + 2 * 441 * 8640)
    one = torch.empty((1, 256, 72, 120), device="meta")
    f1, b1, _ = count(None, one, torch.empty_like(one))
    assert work.least_seconds(b1, f1, "float32") * 1e6 == pytest.approx(29.12, abs=0.05)
    assert f1 / work.PEAK_FLOPS["float32"] > b1 / work.PEAK_BYTES_S
    # a program without K7 (the parent of the change that adds it): no entry
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    assert spec.kernels()["correlation_f32"].ENTRIES == ()
    launches = tracing.Launches()
    with launches.recording():
        pass


def test_k7s_symbol_names_its_group():
    symbols = tracing.Launches().symbols
    name = ("void (anonymous namespace)::correlation_f32_kernel<true>(float const*, "
            "float const*, float*, int, int, int, int, long long, int)")
    assert tracing.symbol_group(name, symbols) == "correlation_f32"
    assert sum(s in name for s in symbols.values()) == 1


def _span(name, a, b, parent=None, _ids=iter(range(1, 10_000))):
    return profiling.Span(name, next(_ids), parent, (0, 1), 7, 1000 * MS + a * MS,
                          1000 * MS + b * MS)


def test_the_cells_readers(monkeypatch):
    k7 = "void (anonymous namespace)::correlation_f32_kernel<true>(float const*)"
    conv = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"
    w0, w1 = 1000 * MS, 2000 * MS
    events = [(k7, 0, w0 + 10 * MS, w0 + 10 * MS + MS // 5, "flow"),
              (k7, 0, w0 + 60 * MS, w0 + 60 * MS + MS // 5, "flow"),
              (conv, 0, w0 + 11 * MS, w0 + 40 * MS, "flow"),
              (conv, 0, w0 + 41 * MS, w0 + 45 * MS, "stylizer")]
    trace = types.SimpleNamespace(bounds=(w0, w1), window_s=1.0, events=events,
                                  spans={"flow": [], "stylizer": []},
                                  symbols=tracing.Launches().symbols,
                                  launches={"correlation_f32": [2, 2 * 29.12e-6]})
    ctx = Context(trace=trace, landed=2, process_ms=[], flops_per_frame=1.8e12,
                  peak_flops=67e12, cards=1)
    assert spec.reader("flow.device_ms")(ctx) == pytest.approx((0.2 + 29 + 0.2) / 2)
    assert spec.reader("step.mfu")(ctx) == pytest.approx(100 * 3.6e12 / 67e12)
    assert spec.reader("correlation.roofline")(ctx) == pytest.approx(100 * 29.12 / 200)
    # spans: the first frame's provider call estimates no pair
    f0, f1, f2 = _span("flow", 0, 5), _span("flow", 10, 50), _span("flow", 60, 90)
    spans = [f0, f1, f2]
    for f, t in ((f1, 11), (f2, 61)):
        c = _span("flow.fn2.c", t, t + 4, f.id)
        spans += [c, _span("kernel.K7", t + 1, t + 2, c.id)]
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: spans)
    assert spec.reader("correlation.launches")(ctx) == pytest.approx(1.0)
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: [f0, f1])
    assert spec.reader("correlation.launches")(ctx) is None
    trace.launches = {}
    assert spec.reader("correlation.roofline")(ctx) is None


def test_the_cell_runs_correct_at_a_small_size():
    """The cell through ``run_cell`` on the CPU, its frames cut to 128x256
    (flow at 64x128), every other frame checked: weights drawn from the
    seed, the program's flow checkpoint written and read, the reference's
    recurrence against the program's frames."""
    cell = spec.cell(CELL)
    cell.config["geometry"] = {"kind": "frame", "height": 128, "width": 256}
    cell.traffic["check"]["every"] = 2
    torch.set_num_threads(2)
    result, faults = run_cell(cell, SEED, 5.0, False, [torch.device("cpu")], time.monotonic())
    assert faults == []
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 3 and result["failed"] == 0
