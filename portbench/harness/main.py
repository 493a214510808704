"""One run of one cell: set-up, the measured window, the reading of the
trace, the check against the reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last the numbers compared with their limits under
``checks``); the numbers compared also end standard error. A run prints no
result and exits with 2 without a card (or with fewer cards than the cell
asks for), and with 1 when anything fails, the import check included.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np


# torch's threads for the host's own tensor work (frame copies, pinning):
# few, so that a run's host work does not spread over a shared host's cores
HOST_THREADS = 2


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


@dataclasses.dataclass
class Context:
    """What a per-layer reader takes (see ``portbench/metrics/``)."""
    trace: object                 # tracing.Trace of the window
    landed: int                   # frames that landed inside the traced window
    process_ms: List[float]       # the pool's process calls inside it
    flops_per_frame: float        # the model's operations per frame (reference)
    peak_flops: float             # the card's peak for the cell's precision
    cards: int
    latency_ms: List[float] = dataclasses.field(default_factory=list)
    # each frame landed inside the traced window: hand-over to landing


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def checked_streams(traffic: dict, seed: int) -> List[int]:
    """The streams checked: a driver's one; in a pool, streams drawn from
    the seed."""
    if traffic["entry"] != "stream_pool":
        return [0]
    n = int(traffic["streams"])
    rng = np.random.default_rng([seed, 2])
    return sorted(int(s) for s in rng.choice(n, size=min(n, int(traffic["check"]["streams"])),
                                             replace=False))


def run_cell(cell, seed: int, seconds: float, trace: bool, devices, t_start: float,
             dtype: Optional[str] = None, bench_dir: Optional[str] = None):
    """Run `cell` once on `devices`; returns (result dict, faults)."""
    import torch

    from ..reference import stylizer as net_ref
    from ..reference import vr_maps
    from . import check, entries, frames, spec, tracing, weights, work

    bench_dir = bench_dir or spec.BENCH_DIR
    cfg, tr = cell.config, cell.traffic
    dtype = dtype or cfg["dtype"]
    geo = cfg["geometry"]
    faces = geo["kind"] == "cube_faces"
    h, w = (int(geo["face"]),) * 2 if faces else (int(geo["height"]), int(geo["width"]))
    n_pans = 6 if faces else int(tr.get("streams", 1))
    flow_model = spec.flow_model(cfg)
    flow = spec.flow_reference(flow_model, bench_dir)

    net = net_ref.parse(cfg["arch"], int(cfg["in_channels"]))
    params = weights.draw(net, seed, devices[0])
    tmp = entries.run_dir()
    try:
        ckpt = os.path.join(tmp, "stylizer.npz")
        weights.write_checkpoint(ckpt, params, cfg)
        if cfg["flow"]["weights"] == "seed":
            # the flow's weights from the seed, on a stream of the family's
            # own, as the program's flow checkpoint
            flow_path = os.path.join(tmp, "flow.npz")
            flow.save(flow_path, flow.draw(seed, devices[0]))
        else:
            flow_path = os.path.join(os.path.dirname(bench_dir), cfg["flow"]["weights"])
        source = frames.Source(seed, max(h, w))
        pans = source.pans(n_pans, h, w, tr["pan"])
        every = int(tr["check"]["every"])
        cap = int(entries.FRAME_CAP_FPS * seconds) + 10
        draws = {s: set(check.drawn(seed, s, every, cap).tolist())
                 for s in checked_streams(tr, seed)}
        rec = entries.Record(
            seconds,
            keep_output=lambda s, t: s in draws and (t in draws[s] or t + 1 in draws[s]),
            keep_state=lambda s, t: s in draws and t + 1 in draws[s])
        vr = None
        if faces:
            maps = vr_maps.border_maps(h, int(geo["overlap"]))
            vr = (h, [work.mapped_area(m) for m in maps])
        job = entries.Job(cfg, tr, pans, ckpt, flow_path,
                          spec.flow_program(flow_model, bench_dir).program_params,
                          devices, dtype, trace, rec,
                          launches=tracing.Launches(vr, bench_dir) if trace else None)
        state = entries.ENTRIES[tr["entry"]](job)
        gc.unfreeze()
        if rec.t0 is None:
            raise RuntimeError("the window never opened")
        setup_s = rec.t0 - t_start
        t0, t1 = rec.t0, rec.t1
        frames_all = list(rec.frames.values())
        in_window = [f for f in frames_all if f.landed is not None and t0 <= f.landed <= t1]
        attempted = len(frames_all)
        failed = sum(1 for f in frames_all if f.landed is None) + len(rec.errors)
        cuda = [d for d in devices if d.type == "cuda"]
        memory_peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)

        metrics, device_extra, breakdown = {}, {}, None
        if not trace:
            values = {"setup_s": setup_s, "frames_per_s": len(in_window) / seconds}
            if in_window:
                values["frame_latency_ms_p95"] = _percentile(
                    [(f.landed - f.submitted) * 1e3 for f in in_window], 95)
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            tr_obj = tracing.read(job.profile, job.launches, len(devices))
            job.profile = None
            _log(f"portbench: trace attribution {tr_obj.stats}")
            c0, c1 = rec.t0, rec.closed_at
            ctx = Context(
                trace=tr_obj,
                landed=sum(1 for f in frames_all if f.landed is not None
                           and c0 <= f.landed <= c1),
                process_ms=[ms for t, ms in job.process_ms if c0 <= t <= c1],
                latency_ms=[(f.landed - f.submitted) * 1e3 for f in frames_all
                            if f.landed is not None and c0 <= f.landed <= c1],
                flops_per_frame=work.model_flops(net, params, flow, flow.load(flow_path, "cpu"),
                                                 (h, w), 6 if faces else 1,
                                                 float(cfg["flow"]["scale"])),
                peak_flops=work.PEAK_FLOPS[dtype], cards=len(devices))
            for name, read in spec.readers(cell.per_layer, bench_dir).items():
                v = read(ctx)
                if v is not None:
                    unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                    metrics[name] = {"value": float(v), "unit": unit}
            device_extra = {"busy_s": float(np.mean(list(tr_obj.busy_s.values()))),
                            "window_s": tr_obj.window_s}
            breakdown = {"device_ops": tracing.device_ops(tr_obj),
                         "idle_gaps": [[n, s] for n, s in tr_obj.idle_gaps]}
        outputs, states = rec.outputs, rec.states
        errors = list(rec.errors)
        submitted = {}
        for f in frames_all:
            submitted[f.stream] = submitted.get(f.stream, 0) + 1
        samples = {s: sorted(t for t in d if t < submitted.get(s, 0)) for s, d in draws.items()}
        del state, job, rec
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        flow_params = flow.load(flow_path, devices[0])
        make = check.reference_streams(cfg, params, flow, flow_params, devices[0])
        if faces:
            def frame_of(s, t):
                return np.stack([p.frame(t) for p in pans])
        else:
            def frame_of(s, t):
                return pans[s].frame(t)
        numbers, faults = check.compare(outputs, states, samples, frame_of, make, devices[0])
        del states
        faults = errors + faults
        correct, shown = check.judge(numbers, faults, spec.limits(cell.name, bench_dir))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": len(devices),
              "memory_peak_bytes": int(memory_peak)}
    device.update(device_extra)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    return result, faults


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import guard, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        _log("portbench: no CUDA card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"portbench: {args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.set_num_threads(HOST_THREADS)
    result, faults = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, t_start)
    bad = guard.loaded()
    if bad:
        _log(f"portbench: the run loaded {bad}")
        return 1
    _log(f"portbench: {result['device']['kind']}, {_power_limit()}")
    for f in faults:
        _log(f"portbench: fault: {f}")
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
