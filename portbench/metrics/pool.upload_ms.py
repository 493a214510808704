"""pool.upload_ms: the host's milliseconds in the serving pool's uploads
(the program's ``pool.upload`` spans: a frame, and flow and certainty when
the caller passes them, pinned and copied to the card) in the traced
window, per ``pool.process`` span in it. Nothing to read outside the
serving pool, or where the program records no such span."""

from fast_artistic_videos_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans(*ctx.trace.bounds)
    calls = sum(1 for s in got if s.name == "pool.process")
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in got if s.name == "pool.upload") / 1e6 / calls
