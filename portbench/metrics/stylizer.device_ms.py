"""stylizer.device_ms: the device time of the operations launched inside
the stylizer's forward (the engine's ``apply_vid``) during the traced
window, per frame landed in it (per 360-degree frame of six faces)."""


def read(ctx):
    t = ctx.trace
    if "stylizer" not in t.spans or not ctx.landed:
        return None
    w0, w1 = t.bounds
    ns = sum(b - a for _, _, a, b, span in t.events if span == "stylizer" and w0 <= a < w1)
    return ns / 1e6 / ctx.landed if ns else None
