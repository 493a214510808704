"""pool.host_ms: the host's milliseconds in each ``StreamPool.process``
call inside the traced window, by the host clock, averaged over the calls.
Nothing to read outside the serving pool."""


def read(ctx):
    if not ctx.process_ms:
        return None
    return sum(ctx.process_ms) / len(ctx.process_ms)
