"""flow.host_ms: the host's milliseconds in the flow provider (the
program's ``flow`` spans, on any thread; ``flow.band_wait`` inside them) in
the traced window, per frame landed in it. Nothing to read where the
program records no such span."""

from fast_artistic_videos_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None or not ctx.landed:
        return None
    got = [s for s in spans(*ctx.trace.bounds) if s.name == "flow"]
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / ctx.landed
