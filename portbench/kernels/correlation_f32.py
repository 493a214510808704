"""K7, FlowNetC's correlation (``csrc/correlation_f32.cu``:
``fav_correlation_f32``; the entry is ``correlation_kernel.correlation``),
float32.

Operations: a multiply-add for each of the 441 displacements, each channel
and each pixel of each image; bytes: the two maps read once (once where
both are the same tensor, the two directions of a pair in one batch) and
the 441 channels written. At FlowNetC's 1080p shape (72 x 120 x 256) an
image takes at least 29.1 us, bound by operations (1.951 GFLOP); its 33 MB
take 9.8 us. A program without K7 has no such entry: nothing is counted."""

import importlib.util

SYMBOL = "correlation_f32"
MODULE = "fast_artistic_videos_tpu_torch.ops.correlation_kernel"


def correlation_work(a_shape, same: bool):
    """(flops, bytes) of one launch on (N, C, H, W) maps."""
    n, c, h, w = a_shape
    flops = 2 * 441 * c * n * h * w
    nbytes = 4 * (n * c * h * w * (1 if same else 2) + n * 441 * h * w)
    return flops, nbytes


def _correlation(vr, a, b, out=None, b_shift=0):
    return (*correlation_work(tuple(a.shape), a is b), "float32")


ENTRIES = ((MODULE, "correlation", _correlation),) if importlib.util.find_spec(MODULE) else ()
