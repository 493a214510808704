"""stylizer.host_ms: the host's milliseconds in the stylizer's forward
(the program's ``stylizer`` spans: launching its kernels) in the traced
window, per frame landed in it (per 360-degree frame of six faces).
Nothing to read where the program records no such span."""

from fast_artistic_videos_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None or not ctx.landed:
        return None
    got = [s for s in spans(*ctx.trace.bounds) if s.name == "stylizer"]
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / ctx.landed
