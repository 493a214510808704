"""device.idle_share: the share (%) of the traced window in which no
operation ran on the card, from the union of the trace's device
intervals, averaged over the cell's cards."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.busy_s:
        return None
    busy = sum(t.busy_s.values()) / len(t.busy_s)
    return 100.0 * (1.0 - busy / t.window_s)
