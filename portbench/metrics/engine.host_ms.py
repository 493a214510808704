"""engine.host_ms: the host's milliseconds in the engine outside the
stylizer's forward in the traced window, per frame landed in it: the self
time of the program's ``engine.step``, ``vr.prior``, ``vr.blend`` and
``vr.outputs`` spans less their ``stylizer`` descendants. Nothing to read
where the program records no such span."""

from fast_artistic_videos_tpu_torch.utils import profiling

ENGINE = ("engine.step", "vr.prior", "vr.blend", "vr.outputs")


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None or not ctx.landed:
        return None
    got = spans(*ctx.trace.bounds)
    if not any(s.name in ENGINE for s in got):
        return None
    return profiling.self_ns(got, ENGINE, ("stylizer",)) / 1e6 / ctx.landed
