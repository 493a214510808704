"""flow.device_ms: the device time of the operations launched inside the
flow provider's spans during the traced window, per frame landed in it.
Nothing to read where no provider span was open."""


def read(ctx):
    t = ctx.trace
    if "flow" not in t.spans or not ctx.landed:
        return None
    w0, w1 = t.bounds
    ns = sum(b - a for _, _, a, b, span in t.events if span == "flow" and w0 <= a < w1)
    return ns / 1e6 / ctx.landed if ns else None
