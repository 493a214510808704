"""step.mfu: the model's operations per frame (counted once on the
reference by FlopCounterMode: the stylizer and both flow directions) times
the frames landed in the traced window, over the window's length, the
cell's cards and the card's peak for the cell's precision, in %."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not ctx.landed:
        return None
    return 100.0 * ctx.flops_per_frame * ctx.landed / (t.window_s * ctx.cards * ctx.peak_flops)
