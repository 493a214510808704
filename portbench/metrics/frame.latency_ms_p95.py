"""frame.latency_ms_p95: the 95th percentile, in milliseconds, of the
latency of every frame that landed inside the traced window, from the
hand-over of its content (the driver's loader call, the pool's
``process`` call) to its uint8 frame in host memory. The host paces these
entries, and its speed swings from run to run by more than an end-to-end
bound may allow, so the tail is read here, per layer. Nothing to read
where no frame landed."""

import numpy as np


def read(ctx):
    if not ctx.latency_ms:
        return None
    return float(np.percentile(np.asarray(ctx.latency_ms, np.float64), 95))
