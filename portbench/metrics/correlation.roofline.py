"""correlation.roofline: the least time of the work of K7's launches
(FlowNetC's correlation, counted by ``kernels/correlation_f32.py``) over
its device time in the traced window, in %, with the matching of records
to launches of ``kernels_roofline``. Nothing to read in a program without
K7, or in a run that launched none."""

from portbench.harness.tracing import roofline


def read(ctx):
    return roofline(ctx.trace, ("correlation_f32",))
