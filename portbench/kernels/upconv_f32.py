"""K6, a nearest 2x upsample folded into the stride-1 zero-padded conv after
it (``csrc/upconv_f32.cu``: ``fav_upconv_f32``; the entry is
``upconv_kernel.upconv``), float32.

The folded operations: output phase (p, q) of a k x k conv with pad
(k - 1) / 2 reads, on each axis, the distinct low-resolution offsets
(p + u - pad) // 2 for u < k (2 for 3x3, 5 for 9x9), a multiply-add each
for every input and output channel at every low-resolution pixel. Bytes:
x, the weights and the bias read, y written (and the prologue's affine and
the statistics where given). At 1080p the canonical tail's two launches
take at least 0.507 ms (3x3, 128 -> 64) and 0.297 ms (9x9, 64 -> 3), both
bound by operations."""

from portbench.harness import work

SYMBOL = "upconv_f32"


def phase_taps(k: int) -> int:
    """The (tap, phase) pairs of the fold: over both axes, the sum over
    the four phases of the low-resolution pixels each reads."""
    pad = (k - 1) // 2
    per_axis = sum(len({(p + u - pad) // 2 for u in range(k)}) for p in (0, 1))
    return per_axis * per_axis


def upconv_work(x_shape, w_shape, *, eff=False, stats=False):
    """(flops, bytes) of one launch: x (N, H, W, Cin), w (Cout, Cin, k, k)
    float32, y (N, 2H, 2W, Cout)."""
    n, h, wd, cin = x_shape
    cout, _, k, _ = w_shape
    flops = 2 * phase_taps(k) * cin * cout * n * h * wd
    nbytes = 4 * (n * h * wd * cin + cout * cin * k * k + cout + n * 4 * h * wd * cout)
    if eff:
        nbytes += 4 * n * 2 * cin
    if stats:
        nbytes += 4 * n * 2 * cout
    return flops, nbytes


def _upconv(vr, x, w, b, *, eff=None, relu=False, stats=False, tanh_scale=None):
    return (*upconv_work(tuple(x.shape), tuple(w.shape), eff=eff is not None, stats=stats),
            "float32")


ENTRIES = (("fast_artistic_videos_tpu_torch.ops.upconv_kernel", "upconv", _upconv),)
