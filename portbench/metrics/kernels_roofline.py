"""kernels_roofline: the least time of the work of the hand-written
kernels K1-K5's launches (counted from their shapes by the files of
``portbench/kernels/`` named below) over their device time in the traced
window, in %. Launches are matched to the trace by the symbol their device
code carries; where the profiler kept more or fewer records of a symbol
than launches were made, that symbol's least time is scaled by the records
it kept. K6 and later kernels have shares of their own, so that this one
stays comparable across PRs. Nothing to read without a launch of K1-K5."""

from portbench.harness.tracing import roofline

GROUPS = ("warp_banded", "conv3x3_f32", "front_f32", "conv_tc", "front_tc", "strip_warp")


def read(ctx):
    return roofline(ctx.trace, GROUPS)
