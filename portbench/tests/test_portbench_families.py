"""Flow families and kernel work counts as files, on the CPU: PWC-lite
through its family file against the direct code path it replaced (the
operation count and the streaming flow), the work counts of K1-K6 read
from ``portbench/kernels/`` against the counts that were written into the
harness before, a new flow family with weights drawn from the seed run
through ``run_cell`` from a copy of the benchmark with no harness file
changed, and the reference stylizer's learned upsampling and C blocks
against the port's plain path."""

import json
import os
import shutil
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import spec, tracing, weights, work  # noqa: E402
from portbench.harness.main import Context, run_cell  # noqa: E402
from portbench.reference import flow as flow_ref  # noqa: E402
from portbench.reference import stylizer as net_ref  # noqa: E402
from portbench.reference import video as vref  # noqa: E402
from portbench.reference import vr_maps  # noqa: E402

BENCH = os.path.join(ROOT, "portbench")
FLOW = os.path.join(ROOT, "fast_artistic_videos_tpu", "assets", "flow_pwclite.npz")
SEED = 2 ** 31 + 5151
TRAIN_DEFAULT = "c9s1-32,d64,d128,R128,R128,R128,R128,R128,u64,u32,c9s1-3"


def _like(net):
    like = {}
    for name, shape, _ in net_ref.param_shapes(net):
        weights.tree_set(like, name, torch.empty(shape, device="meta"))
    return like


def _direct_flops(net, params_like, flow_like, frame_hw, n, flow_scale):
    """The operation count as the harness took it before flow families:
    the stylizer and PWC-lite's pyramid and two refinements under one
    counter."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = frame_hw
    m = net.total_stride
    hp, wp = -(-h // m) * m, -(-w // m) * m
    p = work._meta_tree(params_like)
    fp = work._meta_tree(flow_like)
    hs, ws = flow_ref.scaled(h, w, flow_scale)
    fh = -(-hs // flow_ref.STRIDE) * flow_ref.STRIDE
    fw = -(-ws // flow_ref.STRIDE) * flow_ref.STRIDE
    with FlopCounterMode(display=False) as fc:
        net_ref.forward(p, net, torch.empty((n, hp, wp, net.in_channels), device="meta"))
        feats = flow_ref.pyramid(fp, torch.empty((n, fh, fw, 3), device="meta"))
        flow_ref.refine(fp, feats, feats)
        flow_ref.refine(fp, feats, feats)
    return int(fc.get_total_flops())


@pytest.mark.parametrize("cell", ["canonical-1080p.clip", "canonical-vr922.clip"])
def test_pwclite_through_its_family_counts_the_same_operations(cell):
    cfg = spec.cell(cell).config
    assert spec.flow_model(cfg) == "pwclite"
    family = spec.flow_reference("pwclite")
    net = net_ref.parse(cfg["arch"], int(cfg["in_channels"]))
    geo = cfg["geometry"]
    faces = geo["kind"] == "cube_faces"
    hw = (int(geo["face"]),) * 2 if faces else (int(geo["height"]), int(geo["width"]))
    n, scale = (6 if faces else 1), float(cfg["flow"]["scale"])
    flow_like = family.load(os.path.join(ROOT, cfg["flow"]["weights"]), "cpu")
    got = work.model_flops(net, _like(net), family, flow_like, hw, n, scale)
    assert got == _direct_flops(net, _like(net), flow_like, hw, n, scale)


class _DirectFlow(flow_ref.StreamingFlow):
    """The streaming flow as it called PWC-lite's ``prep`` and ``refine``
    before flow families."""

    def __init__(self, params, scale, erode=0):
        super().__init__(None, params, scale, erode)

    @torch.no_grad()
    def __call__(self, frames_u8):
        n, h, w = frames_u8.shape[:3]
        feats = flow_ref.prep(self.params, frames_u8, self.scale)
        prev, self._prev = self._prev, feats
        if prev is None:
            return None
        hs, ws = flow_ref.scaled(h, w, self.scale)
        low_ab = flow_ref.refine(self.params, feats, prev)[:, :hs, :ws]
        low_ba = flow_ref.refine(self.params, prev, feats)[:, :hs, :ws]
        first = float(low_ab.abs().max()) if self._signal is None else self._signal
        warp_low = flow_ref.flow_band(first)
        band = flow_ref.flow_band(warp_low / self.scale) if self.scale != 1.0 else warp_low
        full = low_ab
        if (hs, ws) != (h, w):
            full = flow_ref.resize_bilinear(low_ab, (h, w)) / self.scale
        limit_low = band * hs / h
        certs, signals = [], []
        for i in range(n):
            c, s = flow_ref.consistency(low_ab[i], low_ba[i], frames_u8[i].float() / 255.0,
                                        2 * warp_low, limit_low, (h, w), self.erode)
            certs.append(c)
            signals.append(s)
        self._signal = float(torch.stack(signals).max())
        return full, torch.stack(certs), band


@pytest.mark.parametrize("n, erode", [(1, 7), (6, 0)])
def test_pwclite_through_its_family_streams_the_same_flow(n, erode):
    from portbench.harness import frames

    family = spec.flow_reference("pwclite")
    params = family.load(FLOW, "cpu")
    pans = frames.Source(SEED, 96, period=256).pans(n, 64, 96, (6, 3))
    got = flow_ref.StreamingFlow(family, params, 0.5, erode)
    want = _DirectFlow(params, 0.5, erode)
    for t in range(4):
        f = torch.from_numpy(np.stack([p.frame(t) for p in pans]))
        a, b = got(f), want(f)
        if t == 0:
            assert a is None and b is None
            continue
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def test_pwclite_draws_the_bundled_layout_and_the_program_reads_it(tmp_path):
    family = spec.flow_reference("pwclite")
    bundled = family.load(FLOW, "cpu")
    drawn = family.draw(SEED, "cpu")
    assert {k: {leaf: tuple(t.shape) for leaf, t in v.items()} for k, v in drawn.items()} == \
        {k: {leaf: tuple(t.shape) for leaf, t in v.items()} for k, v in bundled.items()}
    again = family.draw(SEED, "cpu")
    other = family.draw(SEED + 1, "cpu")
    assert all(torch.equal(drawn[k]["w"], again[k]["w"]) for k in drawn)
    assert not torch.equal(drawn["pyr0_a"]["w"], other["pyr0_a"]["w"])
    # a stream of its own: the stylizer's draw from the same seed is not it
    net = net_ref.parse("c3s1-4,c3s1-3", 3)
    assert not torch.equal(weights.draw(net, SEED, "cpu")["layer00"]["w"].flatten()[:16],
                           drawn["pyr0_a"]["w"].flatten()[:16])
    path = str(tmp_path / "flow.npz")
    family.save(path, drawn)
    read = spec.flow_program("pwclite").program_params(path, "cpu")
    for k, v in drawn.items():
        assert torch.equal(family.load(path, "cpu")[k]["w"], v["w"])
        assert torch.equal(read[k]["w"], v["w"]) and torch.equal(read[k]["b"], v["b"])


# ---------------------------------------------------------------------------
# kernel work counts
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _old_counts(vr):
    """[(entry, args, kwargs, group, (flops, bytes, dtype))]: the launches
    of every entry, with the counts the harness's hard-coded entries gave
    them before the kernel files."""
    out = []
    for dt, name, tc_conv, tc_front in ((torch.float32, "float32", "conv3x3_f32", "front_f32"),
                                        (torch.bfloat16, "bfloat16", "conv_tc", "front_tc")):
        isz = 4 if dt == torch.float32 else 2
        img = _meta(1, 540, 960, 3, dtype=dt)
        out.append((("ops.warp_kernel", "warp_banded"), (img, _meta(1, 540, 960, 2), 8), {},
                    "warp_banded", (*work.warp_work((1, 540, 960, 3), isz), name)))
        x = _meta(290, 500, 128, dtype=dt)
        wt = _meta(128, 128, 3, 3, dtype=dt)
        for kw in ({}, {"eff": _meta(2, 128), "skip": x, "emit_input": True}):
            out.append((("ops.rblock_kernel", "chain_conv"), (x, wt, _meta(128)), kw, tc_conv,
                        (*work.conv_work((1, 290, 500, 128), (128, 128, 3, 3), (288, 498), isz,
                                         eff="eff" in kw, skip="skip" in kw,
                                         emit="emit_input" in kw), name)))
        for xs, ws, stride, pad, ho, eff in (((1160, 2000, 7), (32, 7, 9, 9), 1, 4, (1160, 2000),
                                              False),
                                             ((1160, 2000, 32), (64, 32, 3, 3), 2, 1, (580, 1000),
                                              True)):
            kw = {"eff": _meta(2, xs[2])} if eff else {}
            out.append((("ops.front_kernel", "same_conv"),
                        (_meta(*xs, dtype=dt), _meta(*ws, dtype=dt), _meta(ws[0]), stride, pad),
                        kw, tc_front, (*work.conv_work((1,) + xs, ws, ho, isz, eff=eff), name)))
        xb = _meta(4, 290, 500, 128, dtype=dt)
        for attr, pad in (("conv3x3", 1), ("conv3x3_valid", 0)):
            out.append((("ops.conv_kernel", attr), (xb, wt, _meta(128)), {}, tc_conv,
                        (*work.conv_work((4, 290, 500, 128), (128, 128, 3, 3),
                                         (288 + 2 * pad, 498 + 2 * pad), isz, stats=False),
                         name)))
    face, areas = vr
    div = _meta(face, face)
    for pos in range(1, 6):
        out.append((("ops.strip_warp_kernel.StripSet", "prior"), (object(), pos, [], div), {},
                    "strip_warp", (*work.strip_prior_work(face, areas, vref.PRIOR_TERMS[pos],
                                                          pos in (4, 5)), "float32")))
    out.append((("ops.strip_warp_kernel.StripSet", "blend"), (object(), [], div, div), {},
                "strip_warp", (*work.strip_blend_work(face, areas, vref.BLEND_TERMS), "float32")))
    return out


def _record(vr, calls, monkeypatch):
    """The Launches record of `calls` made on stand-ins of the program's
    entries, with every tensor taken for one on a card."""
    def owner(mod_path):
        return tracing._owner("fast_artistic_videos_tpu_torch." + mod_path)

    monkeypatch.setattr(tracing, "_on_card", lambda args: True)
    for mod_path, attr in {c[0] for c in calls}:
        monkeypatch.setattr(owner(mod_path), attr, lambda *a, **k: None)
    launches = tracing.Launches(vr)
    with launches.recording():
        for (mod_path, attr), args, kwargs, *_ in calls:
            getattr(owner(mod_path), attr)(*args, **kwargs)
    return launches


def test_the_kernel_files_count_k1_to_k5_as_the_harness_did(monkeypatch):
    vr = (922, [work.mapped_area(m) for m in vr_maps.border_maps(922, 128)])
    calls = _old_counts(vr)
    launches = _record(vr, calls, monkeypatch)
    want = [(g, work.least_seconds(nb, fl, dt)) for _, _, _, g, (fl, nb, dt) in calls]
    assert launches.items == want
    assert set(launches.by_group()) == {"warp_banded", "conv3x3_f32", "front_f32", "conv_tc",
                                        "front_tc", "strip_warp"}
    # a 2D cell states no face geometry: K5's calls are not counted
    assert tracing.Launches(None).kernels["strip_warp"].ENTRIES[0][2](
        None, object(), 1, [], _meta(4, 4)) is None


@pytest.mark.parametrize("x, w, ms", [((1, 270, 480, 128), (64, 128, 3, 3), 0.507),
                                      ((1, 540, 960, 64), (3, 64, 9, 9), 0.297),
                                      ((1, 231, 231, 128), (64, 128, 3, 3), 0.209),
                                      ((1, 462, 462, 64), (3, 64, 9, 9), 0.122)])
def test_k6_counts_the_folded_work_of_each_tail_launch(x, w, ms, monkeypatch):
    from fast_artistic_videos_tpu_torch.ops import upconv_kernel

    k6 = spec.kernels()["upconv_f32"]
    assert k6.phase_taps(w[2]) == len(upconv_kernel.tap_phases(w[2]))
    call = (("ops.upconv_kernel", "upconv"), (_meta(*x), _meta(*w), _meta(w[0])),
            {"eff": _meta(x[0], 2, x[3]), "relu": True, "stats": w[0] > 3}, None, None)
    launches = _record(None, [call], monkeypatch)
    [(group, seconds)] = launches.items
    assert group == "upconv_f32"
    assert seconds * 1e3 == pytest.approx(ms, abs=1e-3)
    n, h, wd, cin = x
    flops, _ = k6.upconv_work(x, w)
    assert flops == 2 * k6.phase_taps(w[2]) * cin * w[0] * n * h * wd


@pytest.mark.parametrize("name, group", [
    ("void warp_banded_vec_kernel<float>(float const*, float const*, float*, int, int, int, int,"
     " int)", "warp_banded"),
    ("void (anonymous namespace)::conv3x3_f32_kernel(F32Args)", "conv3x3_f32"),
    ("void (anonymous namespace)::front_f32_k9_kernel(FrontF32Args)", "front_f32"),
    ("void (anonymous namespace)::conv_tc_kernel(TcArgs)", "conv_tc"),
    ("void (anonymous namespace)::front_tc_kernel<3, 3, 2, 32, 64, 1>(FrontArgs)", "front_tc"),
    ("void strip_warp_sum_kernel(SumArgs)", "strip_warp"),
    ("void (anonymous namespace)::upconv_f32_kernel<(anonymous namespace)::K9Cfg>(UpconvArgs)",
     "upconv_f32"),
    ("void (anonymous namespace)::conv_in_kernel(ConvArgs)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_a_kernels_symbol_names_one_group(name, group):
    symbols = tracing.Launches().symbols
    assert tracing.symbol_group(name, symbols) == group
    assert sum(s in name for s in symbols.values()) == (group is not None)


def test_kernels_roofline_leaves_k6_to_its_own_share():
    ms = 1_000_000
    k2 = "void (anonymous namespace)::conv3x3_f32_kernel(F32Args)"
    k6 = "void (anonymous namespace)::upconv_f32_kernel<(anonymous namespace)::K9Cfg>(UpconvArgs)"
    events = [(k2, 0, 0, 2 * ms, "stylizer"), (k2, 0, 5 * ms, 7 * ms, "stylizer"),
              (k6, 0, 10 * ms, 14 * ms, "stylizer"), (k6, 0, -3 * ms, -1 * ms, "stylizer")]
    trace = types.SimpleNamespace(
        bounds=(0, 100 * ms), events=events, symbols=tracing.Launches().symbols,
        launches={"conv3x3_f32": [2, 0.002], "upconv_f32": [1, 0.001]})
    ctx = Context(trace=trace, landed=1, process_ms=[], flops_per_frame=0.0, peak_flops=1.0,
                  cards=1)
    assert spec.reader("kernels_roofline")(ctx) == pytest.approx(50.0)
    assert spec.reader("upsample_conv.roofline")(ctx) == pytest.approx(25.0)
    trace.launches = {"conv3x3_f32": [2, 0.002]}
    assert spec.reader("upsample_conv.roofline")(ctx) is None


# ---------------------------------------------------------------------------
# a new flow family by files alone
# ---------------------------------------------------------------------------

SEEDED_REFERENCE = '''"""A flow family for the test: PWC-lite, its weights drawn from the seed."""

from portbench.reference.flow_pwclite import (STRIDE, draw, features, flops, load, pair,  # noqa
                                              save, scaled)
'''

SEEDED_PROGRAM = '''"""The program's half of the test's flow family."""


def program_params(path, device):
    from fast_artistic_videos_tpu_torch.flow import estimator

    return estimator.load_params(path, device)
'''


@pytest.mark.parametrize("traffic", ["clip", "serve8"])
def test_a_seeded_flow_family_runs_correct_with_no_harness_file_changed(traffic, tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "portbench"
    try:
        before = {p: (bench / "harness" / p).read_bytes()
                  for p in os.listdir(bench / "harness") if p.endswith(".py")}
        (bench / "reference" / "flow_pwclite_seeded.py").write_text(SEEDED_REFERENCE)
        (bench / "flows" / "pwclite_seeded.py").write_text(SEEDED_PROGRAM)
        cfg = json.loads((bench / "configs" / "canonical-1080p.json").read_text())
        cfg["geometry"] = {"kind": "frame", "height": 64, "width": 96}
        cfg["flow"] = {"model": "pwclite_seeded", "weights": "seed", "scale": 0.5}
        (bench / "configs" / "seeded-flow.json").write_text(json.dumps(cfg))
        name = f"seeded-flow.{traffic}"
        shutil.copy(bench / "limits" / f"canonical-1080p.{traffic}.json",
                    bench / "limits" / f"{name}.json")
        b = json.loads((root / "BENCHMARK.json").read_text())
        b["configs"].append({"name": "seeded-flow", "source": "https://example.org",
                             "file": "portbench/configs/seeded-flow.json", "reduced": [],
                             "why": "a flow family drawn from the seed"})
        b["workloads"].append({"name": name, "config": "seeded-flow", "traffic": traffic,
                               "chips": 1, "why": "the test's"})
        (root / "BENCHMARK.json").write_text(json.dumps(b))

        cell = spec.cell(name, root=str(root), bench_dir=str(bench))
        cell.traffic["check"]["every"] = 2
        if cell.traffic["entry"] == "stream_pool":
            cell.traffic["streams"] = 3
            cell.traffic["check"]["streams"] = 2
        devices = [torch.device("cpu")] * (2 if traffic == "serve8" else 1)
        torch.set_num_threads(2)
        result, faults = run_cell(cell, SEED, 2.0, False, devices, time.monotonic(),
                                  bench_dir=str(bench))
        assert faults == []
        assert result["correct"] is True, result["checks"]
        assert result["attempted"] > 3 and result["failed"] == 0
        assert {p: (bench / "harness" / p).read_bytes() for p in before} == before
    finally:
        shutil.rmtree(root)
    assert not root.exists()


# ---------------------------------------------------------------------------
# the stylizer's grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [TRAIN_DEFAULT, "c9s1-16,d32,d64,C64,R64,f3s2-32,u16,c9s1-3"])
def test_the_reference_runs_learned_upsampling_and_c_blocks_as_the_port(arch, tmp_path):
    from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer
    from fast_artistic_videos_tpu_torch.models.arch_dsl import parse_arch

    net = net_ref.parse(arch)
    port_spec = parse_arch(arch)
    assert (net.input_pad, net.total_stride) == (port_spec.input_pad, port_spec.total_stride)
    params = weights.draw(net, SEED, "cpu")
    x = torch.randn(1, 64, 96, 7, generator=torch.Generator().manual_seed(3)) * 50
    with net_ref.float32():
        want = net_ref.forward(params, net, x)
    assert want.shape == (1, 64, 96, 3)
    got = stylizer.apply(params, port_spec, x, fused=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # the checkpoint the harness writes holds the same net for the program
    cfg = {"arch": arch, "in_channels": 7, "padding_type": "reflect-start",
           "use_instance_norm": True, "tanh_constant": 150.0}
    path = str(tmp_path / "stylizer.npz")
    weights.write_checkpoint(path, params, cfg)
    spec_read, read, _ = checkpoint.load_model(path, "cpu")
    assert torch.equal(stylizer.apply(read, spec_read, x, fused=False), got)
