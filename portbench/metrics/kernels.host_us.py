"""kernels.host_us: the host's microseconds a call of a hand-written
kernel's Python entry takes on the card (the program's ``kernel.K1`` to
``kernel.K5`` spans: checks, packing and the launch), averaged over the
calls in the traced window. Nothing to read without such a span."""

from fast_artistic_videos_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = [s.end_ns - s.start_ns for s in spans(*ctx.trace.bounds)
           if s.name.startswith("kernel.K")]
    if not got:
        return None
    return sum(got) / len(got) / 1e3
