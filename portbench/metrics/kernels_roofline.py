"""kernels_roofline: the least time of the work of the hand-written
kernels' launches (K1-K5, counted from their shapes by harness.work) over
their device time in the traced window, in %. Launches are matched to the
trace by the symbol their device code carries; where the profiler kept
more or fewer records of a symbol than launches were made, that symbol's
least time is scaled by the records it kept. Nothing to read without a
launch of a hand-written kernel."""

from portbench.harness.tracing import symbol_group


def read(ctx):
    t = ctx.trace
    w0, w1 = t.bounds
    device_ns, records = {}, {}
    for name, _, a, b, _ in t.events:
        g = symbol_group(name)
        if g is None or not (w0 <= a < w1):
            continue
        device_ns[g] = device_ns.get(g, 0) + (b - a)
        records[g] = records.get(g, 0) + 1
    least = busy = 0.0
    for g, (launches, seconds) in t.launches.items():
        if g not in device_ns or not launches:
            continue
        least += seconds * records[g] / launches
        busy += device_ns[g] / 1e9
    if busy <= 0.0:
        return None
    return 100.0 * least / busy
