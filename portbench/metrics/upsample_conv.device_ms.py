"""upsample_conv.device_ms: the device time of K6, the folded upsample conv
(the kernel symbol ``upconv_f32``), in the traced window, per frame landed
in it (per 360-degree frame of six faces). Its least time by the folded
operations is 0.81 ms a 1080p frame (PERF.md). Nothing to read in a program
without K6, or in a run that launched none."""

SYMBOL = "upconv_f32"


def read(ctx):
    t = ctx.trace
    if not ctx.landed:
        return None
    w0, w1 = t.bounds
    ns = sum(b - a for name, _, a, b, _ in t.events if SYMBOL in name and w0 <= a < w1)
    return ns / 1e6 / ctx.landed if ns else None
