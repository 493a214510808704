"""driver.wait_ms: the milliseconds the drivers' loop thread waited in the
traced window, per frame landed in it: the program's spans
``pipeline.prefetch_wait`` (the loop waiting for the prefetch thread's next
frame) and ``pipeline.writer_wait`` (the loop waiting for room in the
writer's queue). Nothing to read where the program records no such span."""

from fast_artistic_videos_tpu_torch.utils import profiling

WAITS = ("pipeline.prefetch_wait", "pipeline.writer_wait")


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None or not ctx.landed:
        return None
    got = [s for s in spans(*ctx.trace.bounds) if s.name in WAITS]
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / ctx.landed
