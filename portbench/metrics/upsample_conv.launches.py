"""upsample_conv.launches: K6's launches per call of the stylizer's forward
in the traced window: the program's ``kernel.K6`` spans inside its
``stylizer`` spans, over the ``stylizer`` spans. The canonical net in
float32 reads 2, one a nearest 2x upsample folded into the conv after it.
Nothing to read in a program without the spans or without K6."""

from fast_artistic_videos_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans(*ctx.trace.bounds)
    by_id = {s.id: s for s in got}
    calls = sum(1 for s in got if s.name == "stylizer")
    launches = 0
    for s in got:
        if s.name != "kernel.K6":
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != "stylizer":
            p = by_id.get(p.parent)
        launches += p is not None
    return launches / calls if calls and launches else None
