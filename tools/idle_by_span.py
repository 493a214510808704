"""Split a traced benchmark run's idle time on card 0 by the program's spans.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> [--seconds 20]

From the root of a checkout, on a machine with the cell's cards. Runs the
cell once as ``portbench/run.py --trace 1`` does, then splits every stretch
of the traced window in which no operation ran on card 0 by the innermost
span of the program (``utils.profiling``) open at that time: on the loop
thread (the thread that drives the cell's loop), and on every thread (the
set of each thread's innermost span, joined by '+'). Prints one JSON line:
the run's per-layer metrics, the window, the idle time, both splits in ms
and in % of the idle time ("no span": no program span open), and each
span name's count and ms in the window.
"""

import argparse
import json
import os
import sys
import threading
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def idle_intervals(trace, card=0):
    """The stretches of the window with no operation on `card`."""
    from portbench.harness import tracing

    w0, w1 = trace.bounds
    _, busy = tracing._union([(a, b) for _, c, a, b, _ in trace.events if c == card], w0, w1)
    out, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


def _innermost(open_spans):
    return max(open_spans, key=lambda s: (s.start_ns, -s.end_ns))


def split(idle, spans, loop):
    """{name: ns} of the idle time under the innermost span open on the
    loop thread, and {names: ns} under the innermost spans open on every
    thread (joined by '+')."""
    edges = []
    for s in spans:
        edges.append((s.start_ns, 1, s))
        edges.append((s.end_ns, 0, s))
    edges.sort(key=lambda e: (e[0], e[1]))
    on_loop, on_any = defaultdict(int), defaultdict(int)
    open_by_thread = defaultdict(list)
    k, t = 0, None
    for lo, hi in idle:
        t = lo
        while True:
            # apply every edge at or before t, then run to the next edge
            while k < len(edges) and edges[k][0] <= t:
                _, opens, s = edges[k]
                stack = open_by_thread[s.thread]
                if opens:
                    stack.append(s)
                elif s in stack:
                    stack.remove(s)
                k += 1
            nxt = min(hi, edges[k][0]) if k < len(edges) else hi
            if nxt > t:
                mine = open_by_thread.get(loop)
                on_loop[_innermost(mine).name if mine else "no span"] += nxt - t
                names = sorted({_innermost(st).name for st in open_by_thread.values() if st})
                on_any["+".join(names) or "no span"] += nxt - t
            t = nxt
            if t >= hi:
                break
    return dict(on_loop), dict(on_any)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    t_start = time.monotonic()

    import torch

    from fast_artistic_videos_tpu_torch.utils import profiling
    from portbench.harness import main as harness, spec, tracing

    if not torch.cuda.is_available():
        print("idle_by_span: no CUDA card", file=sys.stderr)
        return 2
    kept = {}
    read = tracing.read

    def keep(*a, **kw):
        kept["trace"] = read(*a, **kw)
        return kept["trace"]

    tracing.read = keep
    cell = spec.cell(args.workload)
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.set_num_threads(harness.HOST_THREADS)
    profiling.clear()
    result, _ = harness.run_cell(cell, args.seed, args.seconds, True, devices, t_start)
    trace = kept["trace"]
    w0, w1 = trace.bounds
    spans = [s._replace(start_ns=max(s.start_ns, w0), end_ns=min(s.end_ns, w1))
             for s in profiling.spans() if s.end_ns > w0 and s.start_ns < w1]
    idle = idle_intervals(trace)
    total = sum(b - a for a, b in idle)
    on_loop, on_any = split(idle, spans, threading.main_thread().ident)

    counts = defaultdict(lambda: [0, 0.0])
    for s in spans:
        counts[s.name][0] += 1
        counts[s.name][1] += (s.end_ns - s.start_ns) / 1e6

    def table(d):
        return {k: [v / 1e6, 100.0 * v / total] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])}

    print(json.dumps({"workload": args.workload, "correct": result["correct"],
                      "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                      "window_ms": (w1 - w0) / 1e6, "idle_ms": total / 1e6,
                      "dropped": profiling.dropped(),
                      "device_ops": [n for n, _ in result["breakdown"]["device_ops"]],
                      "idle_gaps": result["breakdown"]["idle_gaps"],
                      "loop_thread": table(on_loop), "any_thread": table(on_any),
                      "spans": dict(counts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
