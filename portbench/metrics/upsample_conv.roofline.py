"""upsample_conv.roofline: the least time of the folded work of K6's
launches (the folded upsample conv, counted by ``kernels/upconv_f32.py``)
over its device time in the traced window, in %, with the matching of
records to launches of ``kernels_roofline``. Nothing to read in a program
without K6, or in a run that launched none."""

from portbench.harness.tracing import roofline


def read(ctx):
    return roofline(ctx.trace, ("upconv_f32",))
