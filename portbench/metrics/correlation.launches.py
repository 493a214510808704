"""correlation.launches: K7's launches per pair the flow provider estimated
in the traced window: the program's ``kernel.K7`` spans inside its ``flow``
spans, over the ``flow`` spans that estimated a pair (those holding a
``flow.fn2.c`` span, FlowNetC's; a clip's first frame has no pair).
FlowNet 2.0 correlates both directions of a pair in one launch, so the
FlowNet 2.0 cell reads 1. Nothing to read in a program without the spans
or without K7."""

from fast_artistic_videos_tpu_torch.utils import profiling


def _inside(s, name, by_id):
    p = by_id.get(s.parent)
    while p is not None and p.name != name:
        p = by_id.get(p.parent)
    return p


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    got = spans(*ctx.trace.bounds)
    by_id = {s.id: s for s in got}
    pairs = {p.id for p in (_inside(s, "flow", by_id) for s in got if s.name == "flow.fn2.c")
             if p is not None}
    launches = sum(1 for s in got if s.name == "kernel.K7"
                   and _inside(s, "flow", by_id) is not None)
    return launches / len(pairs) if pairs and launches else None
