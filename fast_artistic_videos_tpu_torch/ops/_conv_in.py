"""The instance-norm conv shared by kernels K2 (``rblock_kernel``) and K3
(``front_kernel``): wrapper of ``csrc/conv_in.cu``, ``csrc/conv_tc.cu``,
``csrc/front_tc.cu``, ``csrc/conv3x3_f32.cu`` and ``csrc/front_f32.cu``,
and its plain version.

    a = [+ skip[+2, +2]] ( [relu] ( eff[0] * x + eff[1] ) )   (prologue)
    y = conv(zero_pad(a), w, stride, pad) + b                  (f32 accumulate)
    stats = [sum; sum of squares] of y as stored, per output channel

x is (H, W, Cin) NHWC in float32 or bfloat16; weights are OIHW (the port's
parameter layout) and are cast to x's dtype, as the Pallas kernels do.
Values are rounded to the storage dtype after the affine, after the skip
add and at the store; the statistics are float32.

Four routes, chosen by :func:`conv_route`, a pure function of the dtype
and the conv's shape that names the C entry. In bfloat16
(:func:`tensor_core_route`): 3x3 stride-1 convs with Cin % 64 == 0 and
Cout % 128 == 0 (every conv of the R128 residual chain, K2, and every block
conv of K4) launch the tensor-core kernel ``conv_tc.cu`` (entry
``fav_conv_tc``); the front's shapes (K3: 9x9 stride 1 pad 4 with Cin <= 8
and Cout % 32 == 0, layer 0; 3x3 stride 2 pad 1 with Cin % 32 == 0 and
Cout % 64 == 0, layers 1 and 2) launch the tensor-core kernel
``front_tc.cu`` (entry ``fav_front_tc``, weights packed by
:func:`pack_front_weights`). In float32, 3x3 stride-1 convs with pad 0 or
1, Cin % 8 == 0 and Cout % 128 == 0 (every K2 and K4 conv of the
stylizer) launch the register-tiled CUDA-core kernel ``conv3x3_f32.cu``
(entry ``fav_conv3x3_f32``, weights packed by
:func:`pack_conv3x3_f32_weights`), and the front's shapes (9x9 stride 1
pad 4 with Cin <= 8 and Cout % 32 == 0; 3x3 stride 2 pad 1 with Cin % 8 ==
0 and Cout % 64 == 0) the register-tiled CUDA-core kernel ``front_f32.cu``
(entry ``fav_front_f32``, weights packed by
:func:`pack_front_f32_weights`). Every other shape launches the general
CUDA-core template ``conv_in.cu`` (``fav_conv_in``). Every route raises on
a failed launch; none falls back to another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiling
from ._build import Kernel, no_grad_inputs, ptr

TC_ENTRY = "fav_conv_tc"
FRONT_TC_ENTRY = "fav_front_tc"
TC_ENTRIES = (TC_ENTRY, FRONT_TC_ENTRY)
F32_ENTRY = "fav_conv3x3_f32"
FRONT_F32_ENTRY = "fav_front_f32"
GENERAL_ENTRY = "fav_conv_in"


def tensor_core_route(dtype, kh: int, kw: int, stride: int, pad: int, cin: int,
                      cout: int):
    """The tensor-core C entry a conv launches, or None for the CUDA-core
    template ``conv_in.cu``. Bfloat16 only: ``fav_conv_tc`` for 3x3, stride
    1, pad 0 or 1, Cin % 64 == 0, Cout % 128 == 0; ``fav_front_tc`` for
    9x9, stride 1, pad 4, Cin <= 8, Cout % 32 == 0 and for 3x3, stride 2,
    pad 1, Cin % 32 == 0, Cout % 64 == 0."""
    if dtype != torch.bfloat16 or kh != kw:
        return None
    if kh == 3 and stride == 1 and pad in (0, 1) and cin % 64 == 0 and cout % 128 == 0:
        return TC_ENTRY
    if kh == 9 and stride == 1 and pad == 4 and cin <= 8 and cout % 32 == 0:
        return FRONT_TC_ENTRY
    if kh == 3 and stride == 2 and pad == 1 and cin % 32 == 0 and cout % 64 == 0:
        return FRONT_TC_ENTRY
    return None


def conv_route(dtype, kh: int, kw: int, stride: int, pad: int, cin: int, cout: int) -> str:
    """The C entry a conv launches: the tensor-core entry that
    :func:`tensor_core_route` names in bfloat16; in float32,
    ``fav_conv3x3_f32`` for a 3x3, stride 1, pad 0 or 1 conv with Cin % 8
    == 0 and Cout % 128 == 0, and ``fav_front_f32`` for a 9x9, stride 1,
    pad 4 conv with Cin <= 8 and Cout % 32 == 0 or a 3x3, stride 2, pad 1
    conv with Cin % 8 == 0 and Cout % 64 == 0; ``fav_conv_in`` otherwise."""
    tc = tensor_core_route(dtype, kh, kw, stride, pad, cin, cout)
    if tc is not None:
        return tc
    if dtype != torch.float32 or kh != kw:
        return GENERAL_ENTRY
    if kh == 3 and stride == 1 and pad in (0, 1) and cin % 8 == 0 and cout % 128 == 0:
        return F32_ENTRY
    if kh == 9 and stride == 1 and pad == 4 and cin <= 8 and cout % 32 == 0:
        return FRONT_F32_ENTRY
    if kh == 3 and stride == 2 and pad == 1 and cin % 8 == 0 and cout % 64 == 0:
        return FRONT_F32_ENTRY
    return GENERAL_ENTRY


def front_chunk(kh: int, cin: int) -> int:
    """Input channels per shared-memory chunk of ``front_tc.cu``: 8 for the
    9x9 layer (one 16-byte group per pixel), else 64 when Cin allows, 32."""
    return 8 if kh == 9 else (64 if cin % 64 == 0 else 32)


def pack_front_weights(w):
    """OIHW weights -> the (slices, Cout, 64) bfloat16 layout that
    ``front_tc.cu`` reads, one 64-wide K slice after another. Per input
    chunk of :func:`front_chunk` channels, K walks the kernel rows, then
    the taps of a row, then the chunk's channels; the channels are padded
    to the chunk and a 9-tap row to 10 taps (with 8 channels a k16 step is
    two taps, and a step never straddles two rows), each with zero weights,
    and each chunk's K to a multiple of 64."""
    cout, cin, kh, kw = w.shape
    cp = front_chunk(kh, cin)
    kwp = kw + (kw & 1) if cp == 8 else kw
    nchunk = -(-cin // cp)
    wt = w.to(torch.bfloat16).permute(0, 2, 3, 1)                   # (Cout, KH, KW, Cin)
    wt = F.pad(wt, (0, nchunk * cp - cin, 0, kwp - kw))
    wt = wt.reshape(cout, kh, kwp, nchunk, cp).permute(0, 3, 1, 2, 4)
    k = kh * kwp * cp
    wt = F.pad(wt.reshape(cout, nchunk, k), (0, -(-k // 64) * 64 - k))
    return wt.reshape(cout, -1, 64).permute(1, 0, 2).contiguous()


def pack_conv3x3_f32_weights(w):
    """OIHW weights -> the (Cin, 3, 3, Cout) float32 layout that
    ``conv3x3_f32.cu`` reads: a chunk of 8 input channels is 72 rows (its
    channels, then the taps) of contiguous output channels."""
    return w.float().permute(1, 2, 3, 0).contiguous()


def pack_front_f32_weights(w):
    """OIHW weights -> the float32 layout that ``front_f32.cu`` reads: a
    9x9 kernel as (9, 9, 8, Cout), the input channels padded to 8 with zero
    weights, so that one kernel row is 72 rows ([tap][channel]) of
    contiguous Cout; a 3x3 kernel as (Cin, 3, 3, Cout), the layout of
    :func:`pack_conv3x3_f32_weights`."""
    if w.shape[2] == 3:
        return pack_conv3x3_f32_weights(w)
    wt = w.float().permute(2, 3, 1, 0)                           # (KH, KW, Cin, Cout)
    return F.pad(wt, (0, 0, 0, 8 - w.shape[1])).contiguous()


def _packed(w, attr: str, pack):
    """pack(w), kept on the tensor until it is modified in place (its
    version changes): the stylizer's weights are packed once, not on every
    launch."""
    cached = getattr(w, attr, None)
    if cached is None or cached[0] != w._version:
        cached = (w._version, pack(w))
        setattr(w, attr, cached)
    return cached[1]


def _front_weights(w):
    return _packed(w, "_front_tc_pack", pack_front_weights)


def _f32_weights(w):
    return _packed(w, "_conv3x3_f32_pack", pack_conv3x3_f32_weights)


def _front_f32_weights(w):
    return _packed(w, "_front_f32_pack", pack_front_f32_weights)


def pack_tc_weights(w):
    """OIHW weights -> the (3, 3, Cout, Cin) bfloat16 layout that
    ``conv_tc.cu`` reads."""
    return w.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()


def _tc_weights(w):
    return _packed(w, "_conv_tc_pack", pack_tc_weights)


def rounded_bias(b, dtype):
    """The float32 bias rounded to the storage dtype, as every route reads
    it; kept on the tensor per dtype until b is modified in place."""
    return _packed(b, _BIAS_ATTRS[dtype], lambda t: t.to(dtype).float().contiguous())


_BIAS_ATTRS = {torch.float32: "_bias_float32", torch.bfloat16: "_bias_bfloat16"}


# the 3x3 stride-1 entries: C entry -> (weight packer, whether x, skip and a
# must be 16-byte aligned as well as y and the packed weights)
CONV3X3_ENTRIES = {TC_ENTRY: (_tc_weights, True), F32_ENTRY: (_f32_weights, False)}


def launch_3x3(kernel: Kernel, entry: str, x, w, bt, y, *, pad: int, eff=None,
               relu: bool = False, skip=None, stats=None, a=None, out_relu: bool = False):
    """Launch the 3x3 stride-1 C entry `entry` (a key of
    :data:`CONV3X3_ENTRIES`, as :func:`conv_route` names it) for `kernel`
    on validated CUDA tensors: x (N, H, W, Cin), w OIHW, bt the float32 bias
    rounded to x's dtype, y (N, Ho, Wo, Cout) preallocated; eff / skip /
    stats / a as in :func:`conv_in` (N == 1 for skip and a)."""
    pack, all_aligned = CONV3X3_ENTRIES[entry]
    wt = pack(w)
    for t in ((x, skip, y, a, wt) if all_aligned else (y, wt)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{kernel.name}: {entry} needs 16-byte aligned "
                             f"{'tensors' if all_aligned else 'weights and output'}")
    n, hin, win, cin = x.shape
    kernel.call(entry, x.device, ptr(x), ptr(wt), ptr(bt), ptr(eff), ptr(skip),
                ptr(y), ptr(stats), ptr(a), n, hin, win, cin, w.shape[0], pad,
                int(relu), int(out_relu))


def _prologue(x, eff, relu: bool, skip):
    dtype = x.dtype
    h, w = x.shape[0], x.shape[1]
    if eff is not None:
        x = (x.float() * eff[0].float() + eff[1].float()).to(dtype)
    if relu:
        x = torch.relu(x)
    if skip is not None:
        x = (x.float() + skip[2:2 + h, 2:2 + w].float()).to(dtype)
    return x


def conv_in_plain(x, w, b, *, stride: int, pad: int, eff=None, relu: bool = False,
                  skip=None, emit_input: bool = False):
    """Plain PyTorch version: F.conv2d in x's dtype with the bias inside
    the conv (one rounding to the storage dtype, as in the kernels), and
    float32 statistics of the stored values."""
    dtype = x.dtype
    a = _prologue(x, eff, relu, skip)
    y = F.conv2d(a.permute(2, 0, 1)[None], w.to(dtype), b.to(dtype), stride, pad)
    y = y[0].permute(1, 2, 0)
    yf = y.float()
    stats = torch.stack([yf.sum(dim=(0, 1)), (yf * yf).sum(dim=(0, 1))])
    return (y.contiguous(), stats, a) if emit_input else (y.contiguous(), stats)


def conv_in(kernel: Kernel, x, w, b, *, stride: int, pad: int, eff=None,
            relu: bool = False, skip=None, emit_input: bool = False):
    """Launch `kernel` (K2 or K3) on a CUDA tensor, on the route that
    :func:`conv_route` names (the front's routes take no skip and no
    emission); plain version on CPU. Returns (y,
    stats) or (y, stats, a) with emit_input. Raises on any device when
    asked to carry a gradient (``_build.no_grad_inputs``)."""
    no_grad_inputs(kernel.name, x, w, b, eff, skip)
    if x.device.type == "cpu":
        return conv_in_plain(x, w, b, stride=stride, pad=pad, eff=eff, relu=relu,
                             skip=skip, emit_input=emit_input)
    with profiling.span(kernel.span):
        return _conv_in_card(kernel, x, w, b, stride, pad, eff, relu, skip, emit_input)


def _conv_in_card(kernel: Kernel, x, w, b, stride: int, pad: int, eff, relu: bool, skip,
                  emit_input: bool):
    if x.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {x.device}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel.name}: unsupported dtype {dtype}")
    if x.ndim != 3 or w.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{kernel.name}: x must be contiguous (H, W, C), "
                         f"w OIHW; got {tuple(x.shape)}, {tuple(w.shape)}")
    hin, win, cin = x.shape
    cout, wcin, kh, kw = w.shape
    if wcin != cin or b.shape != (cout,):
        raise ValueError(f"{kernel.name}: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit input channels {cin}")
    for t in (w, b, eff, skip):
        if t is not None and t.device != x.device:
            raise ValueError(f"{kernel.name}: operands on different devices")
    if eff is not None and eff.shape != (2, cin):
        raise ValueError(f"{kernel.name}: eff must be (2, {cin})")
    if skip is not None and (skip.shape != (hin + 4, win + 4, cin)
                             or skip.dtype != dtype or not skip.is_contiguous()):
        raise ValueError(f"{kernel.name}: skip must be contiguous "
                         f"{(hin + 4, win + 4, cin)} {dtype}")
    hout = (hin + 2 * pad - kh) // stride + 1
    wout = (win + 2 * pad - kw) // stride + 1
    if hout < 1 or wout < 1:
        raise ValueError(f"{kernel.name}: empty output for input {(hin, win)}")
    bt = rounded_bias(b, dtype)
    effc = eff.float().contiguous() if eff is not None else None
    y = torch.empty((hout, wout, cout), dtype=dtype, device=x.device)
    stats = torch.zeros((2, cout), dtype=torch.float32, device=x.device)
    a = torch.empty_like(x) if emit_input else None
    route = conv_route(dtype, kh, kw, stride, pad, cin, cout)
    if route in CONV3X3_ENTRIES:
        launch_3x3(kernel, route, x[None], w, bt, y[None], pad=pad, eff=effc, relu=relu,
                   skip=skip, stats=stats, a=a)
        return (y, stats, a) if emit_input else (y, stats)
    if route == FRONT_TC_ENTRY:
        if skip is not None or emit_input:
            raise ValueError(f"{kernel.name}: the front's tensor-core route takes no "
                             f"skip and emits no input")
        if (cin % 32 == 0 and x.data_ptr() % 16) or y.data_ptr() % 16:
            raise ValueError(f"{kernel.name}: the tensor-core route needs 16-byte "
                             f"aligned tensors")
        kernel.call(FRONT_TC_ENTRY, x.device, ptr(x), ptr(_front_weights(w)), ptr(bt),
                    ptr(effc), ptr(y), ptr(stats), hin, win, cin, cout, kh, stride, pad,
                    int(relu))
        return y, stats
    if route == FRONT_F32_ENTRY:
        if skip is not None or emit_input:
            raise ValueError(f"{kernel.name}: the front's float32 route takes no skip "
                             f"and emits no input")
        wt = _front_f32_weights(w)
        if y.data_ptr() % 16 or wt.data_ptr() % 16:
            raise ValueError(f"{kernel.name}: {FRONT_F32_ENTRY} needs 16-byte aligned "
                             f"weights and output")
        kernel.call(FRONT_F32_ENTRY, x.device, ptr(x), ptr(wt), ptr(bt), ptr(effc), ptr(y),
                    ptr(stats), hin, win, cin, cout, kh, stride, pad, int(relu))
        return y, stats
    wt = w.to(dtype).permute(2, 3, 1, 0).contiguous()          # HWIO
    kernel.call(GENERAL_ENTRY, x.device, ptr(x), ptr(wt), ptr(bt), ptr(effc),
                ptr(skip), ptr(y), ptr(stats), ptr(a), hin, win, cin, hout, wout,
                cout, kh, kw, stride, pad, int(relu), int(dtype == torch.bfloat16))
    return (y, stats, a) if emit_input else (y, stats)


def eff_affine(stats, scale, bias, count: int, eps: float = 1e-5):
    """Instance-norm statistics (..., 2, C) -> per-channel (scale, bias)
    pair (..., 2, C), normalized = eff[..., 0, :] * y + eff[..., 1, :]
    (float32 stats, biased variance)."""
    mean = stats[..., 0, :] / count
    var = torch.clamp(stats[..., 1, :] / count - mean * mean, min=0.0)
    es = torch.rsqrt(var + eps) * scale.float()
    eb = bias.float() - mean * es
    return torch.stack([es, eb], dim=-2)
