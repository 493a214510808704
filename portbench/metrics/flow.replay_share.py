"""flow.replay_share: the share of the flow provider's steps in the traced
window that replayed the CUDA graphs of their key without capturing one:
the program's ``flow`` spans that hold a ``flow.replay`` span and no
``flow.capture`` span, over all its ``flow`` spans, in %. A step that runs
eagerly (a key's first frame and first pair) or captures (a band never
seen before) lowers it. Nothing to read in a program without the graphs
(no module ``flow.graphs``), or in a window without a ``flow`` span."""

import importlib.util

from fast_artistic_videos_tpu_torch.utils import profiling

GRAPHS = "fast_artistic_videos_tpu_torch.flow.graphs"


def read(ctx):
    spans = getattr(profiling, "spans", None)
    if spans is None or importlib.util.find_spec(GRAPHS) is None:
        return None
    got = spans(*ctx.trace.bounds)
    steps = {s.id for s in got if s.name == "flow"}
    if not steps:
        return None
    replayed = {s.parent for s in got if s.name == "flow.replay"}
    captured = {s.parent for s in got if s.name == "flow.capture"}
    return 100.0 * len((replayed - captured) & steps) / len(steps)
