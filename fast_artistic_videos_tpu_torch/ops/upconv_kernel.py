"""K6: a nearest 2x upsample folded into the stride-1 zero-padded conv after
it — wrapper of ``csrc/upconv_f32.cu`` and its plain PyTorch version.

K6 replaces no Pallas kernel. It mirrors the JAX package's
``fast_artistic_videos_tpu/models/stylizer.py`` ``_folded_upsample_conv``
(an exact rewrite in XLA convs) for the stylizer's tail, the canonical
net's ``U2 -> c3s1-64 -> U2 -> c9s1-3``:

    a = [relu] ( eff[n, 0] * x + eff[n, 1] )            (prologue, low res)
    y = conv(upsample2(a), w, zero pad (k - 1) / 2) + b  (f32 accumulate)
    y = tanh(y) * tanh_scale                             (the net's last layer)
    stats[n] = [sum; sum of squares] of y per channel    (on request)

``y[2i + p, 2j + q] = sum_{u,v} w[u, v] a[(2i + p + u - P) // 2, (2j + q +
v - P) // 2]``, so each output phase (p, q) is a small conv over the low
resolution input whose weights are the sums of the taps that read the same
pixel (:func:`fold_weights`): 9x9 becomes 5x5 a phase, 3x3 becomes 2x2.
Zero padding of the upsampled tensor is zero padding at low resolution, and
the upsampled tensor never exists. A nearest upsample leaves each channel's
mean and ``E[x^2]`` unchanged, so the instance norm after it takes its
statistics at low resolution (``models/stylizer.py``) and arrives here as
``eff``.

x is (N, H, W, Cin) NHWC float32, weights OIHW; y is (N, 2H, 2W, Cout).
``fav_upconv_f32`` has instances for the shapes :func:`covers` names; the
stylizer's ``layer_plan`` picks the layers. A CUDA tensor launches the
kernel or raises; a CPU tensor runs the plain version. Each launch adds one
to ``KERNEL.launches`` and to ``KERNEL.routes[ENTRY]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..utils import profiling
from ._build import Kernel, no_grad_inputs, ptr
from ._conv_in import _packed, rounded_bias

KERNEL = Kernel("upsample_conv", "fast_artistic_videos_tpu_torch/csrc/upconv_f32.cu",
                "none (mirrors fast_artistic_videos_tpu/models/stylizer.py "
                "_folded_upsample_conv)", "kernel.K6")
ENTRY = "fav_upconv_f32"


def covers(k: int, cin: int, cout: int) -> bool:
    """Whether ``fav_upconv_f32`` has an instance for a k x k conv of cin ->
    cout channels: 9x9 with Cin % 4 == 0 and Cout == 3 (the net's last
    layer), 3x3 with Cin % 8 == 0 and Cout % 32 == 0 (layer 9)."""
    return (k == 9 and cin % 4 == 0 and cout == 3) or (k == 3 and cin % 8 == 0
                                                       and cout % 32 == 0)


def fold_window(k: int):
    """(first offset, span, taps a phase) of the fold of a k x k conv with
    zero pad (k - 1) // 2: phase p of an axis reads low-resolution offsets
    (p + u - pad) // 2 for u < k, inside a window of `span` offsets from
    `first`; each phase takes `taps` of them."""
    pad = (k - 1) // 2
    first = -pad // 2                                   # phase 0, tap 0
    span = (k - pad) // 2 - first + 1                   # to phase 1, tap k - 1
    return first, span, (k - 1 - pad) // 2 - first + 1


def fold_weights(w):
    """OIHW weights (Cout, Cin, k, k) -> the four phase kernels on the
    shared window, (2, 2, Cout, Cin, S, S) in float32: [p, q] holds the
    weights of output phase (p, q), each tap the sum of the taps of w that
    read the same low-resolution pixel (added in the order u, v, as the JAX
    package's ``_folded_upsample_conv`` adds them), zero where the phase
    reads nothing."""
    cout, cin, k, _ = w.shape
    pad = (k - 1) // 2
    first, span, _ = fold_window(k)
    wf = w.float()
    out = torch.zeros((2, 2, cout, cin, span, span), dtype=torch.float32, device=w.device)
    for p in range(2):
        for q in range(2):
            for u in range(k):
                su = (p + u - pad) // 2 - first
                for v in range(k):
                    sv = (q + v - pad) // 2 - first
                    out[p, q, :, :, su, sv] += wf[:, :, u, v]
    return out


def tap_phases(k: int):
    """The (window row, window column, phase row, phase column) combinations
    of the fold of a k x k conv in which the phase reads the window tap, in
    the order ``upconv_f32.cu`` walks them (row-major): 16 for 3x3, 100 for
    9x9."""
    pad = (k - 1) // 2
    first, span, _ = fold_window(k)
    reads = {((p + u - pad) // 2 - first, p) for p in range(2) for u in range(k)}
    return [(du, dv, p, q) for du in range(span) for dv in range(span)
            for p in range(2) for q in range(2) if (du, p) in reads and (dv, q) in reads]


def pack_upconv_weights(w):
    """OIHW weights -> the (Cin, Q, Cout) float32 layout that
    ``upconv_f32.cu`` reads: for each input channel, the folded weights of
    the Q combinations of :func:`tap_phases`, in that order, each a row of
    Cout. Slices and one stack: no copy from the host, no synchronisation."""
    wf = fold_weights(w)                                        # (2, 2, Cout, Cin, S, S)
    return torch.stack([wf[p, q, :, :, du, dv].t() for du, dv, p, q in tap_phases(w.shape[2])],
                       dim=1).contiguous()


def _upconv_weights(w):
    return _packed(w, "_upconv_pack", pack_upconv_weights)


def _union_weights(w):
    return _packed(w, "_upconv_union", lambda t: fold_weights(t).flatten(0, 2))


def _prologue(x, eff, relu: bool):
    if eff is not None:
        x = x.float() * eff[:, 0, None, None, :] + eff[:, 1, None, None, :]
    return torch.relu(x) if relu else x


def upconv_plain(x, w, b, *, eff=None, relu: bool = False, stats: bool = False,
                 tanh_scale=None):
    """Plain version: the prologue, then one F.conv2d at low resolution
    with the four phase kernels stacked on the output channels (pad the
    window's reach), the phases put in place, the bias, the optional tanh;
    float32 statistics of the result per sample. Returns y or (y, stats)."""
    n, h, wd, _ = x.shape
    cout = w.shape[0]
    a = _prologue(x, eff, relu).permute(0, 3, 1, 2)
    first = fold_window(w.shape[2])[0]
    with device_mod.float32_convs():
        y = F.conv2d(a, _union_weights(w), None, 1, -first)    # (N, 4 Cout, H, W)
    y = y.view(n, 2, 2, cout, h, wd).permute(0, 4, 1, 5, 2, 3).reshape(n, 2 * h, 2 * wd, cout)
    y = y + b.float()
    if tanh_scale is not None:
        y = torch.tanh(y) * tanh_scale
    if not stats:
        return y.contiguous()
    st = torch.stack([y.sum(dim=(1, 2)), (y * y).sum(dim=(1, 2))], dim=1)
    return y.contiguous(), st


def upconv(x, w, b, *, eff=None, relu: bool = False, stats: bool = False, tanh_scale=None):
    """K6 on a CUDA tensor (a shape that :func:`covers` names, else
    ValueError); the plain version on a CPU tensor. x (N, H, W, Cin)
    float32, w (Cout, Cin, k, k), b (Cout,), eff (N, 2, Cin) float32 or
    None. Returns y (N, 2H, 2W, Cout), or (y, stats (N, 2, Cout)) with
    `stats`. Raises on any device when asked to carry a gradient."""
    no_grad_inputs(KERNEL.name, x, w, b, eff)
    if x.device.type == "cpu":
        return upconv_plain(x, w, b, eff=eff, relu=relu, stats=stats, tanh_scale=tanh_scale)
    with profiling.span(KERNEL.span):
        return _upconv_card(x, w, b, eff, relu, stats, tanh_scale)


def tanh_args(tanh_scale):
    """(apply_tanh, tanh_scale) as ``fav_upconv_f32`` takes them: the flag
    says whether the tanh applies, so a constant of 0 or below keeps it."""
    return (0, 0.0) if tanh_scale is None else (1, float(tanh_scale))


def _upconv_card(x, w, b, eff, relu: bool, stats: bool, tanh_scale):
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL.name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{KERNEL.name}: unsupported dtype {x.dtype}")
    if x.ndim != 4 or w.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{KERNEL.name}: x must be contiguous (N, H, W, C), w OIHW; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout, wcin, k, kw = w.shape
    if wcin != cin or kw != k or tuple(b.shape) != (cout,):
        raise ValueError(f"{KERNEL.name}: weights {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"are not a square conv of {cin} input channels")
    if not covers(k, cin, cout):
        raise ValueError(f"{KERNEL.name}: no instance for a {k}x{k} conv of {cin} -> {cout}")
    for t in (w, b, eff):
        if t is not None and t.device != x.device:
            raise ValueError(f"{KERNEL.name}: operands on different devices")
    if eff is not None and tuple(eff.shape) != (n, 2, cin):
        raise ValueError(f"{KERNEL.name}: eff must be {(n, 2, cin)}")
    wt = _upconv_weights(w)
    bt = rounded_bias(b, torch.float32)
    effc = eff.float().contiguous() if eff is not None else None
    y = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.float32, device=x.device)
    st = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device) if stats else None
    if wt.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError(f"{KERNEL.name}: {ENTRY} needs 16-byte aligned weights and output")
    KERNEL.call(ENTRY, x.device, ptr(x), ptr(wt), ptr(bt), ptr(effc), ptr(y), ptr(st), n, h,
                wd, cin, cout, k, int(relu), *tanh_args(tanh_scale))
    return (y, st) if stats else y
