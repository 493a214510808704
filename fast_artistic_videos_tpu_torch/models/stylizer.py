"""The feed-forward stylizer network, inference ``apply`` — counterpart of
``fast_artistic_videos_tpu/models/stylizer.py``.

Activations are NHWC at the ``apply`` boundary (as in the JAX package);
each conv runs on an NCHW view of them (channels-last memory, no copy).
Parameters are the nested dict of :func:`models.checkpoint.params_from_numpy`
(conv kernels OIHW, transposed-conv kernels stored pre-flipped like the
JAX package's HWIO ones).

Two execution paths with the same math:

  * plain: PyTorch ops, layer by layer (instance norm with float32
    ``E[x^2] - E[x]^2`` statistics, biased variance, eps 1e-5);
  * kernels (``fused``, the default for CUDA tensors): :func:`layer_plan`
    names, for the input's shape and dtype, the layers that take the front
    conv kernel (``ops.front_kernel``, K3), the residual chain conv kernel
    (``ops.rblock_kernel``, K2), the block conv kernel (``ops.conv_kernel``,
    K4) and the folded upsample conv kernel (``ops.upconv_kernel``, K6) —
    the counterparts of the JAX package's ``fused_front="full"``,
    ``fused_rblocks``, ``pallas_conv`` and ``_folded_upsample_conv``. K3,
    K2 and K6 take a pending norm + ReLU in their prologues and give norm
    statistics (K6: or the net's tanh) in their epilogues.

The JAX package's other TPU-layout rewrites (phase-domain front,
space-to-depth convs, phase io) are exact re-expressions of the same convs
for the TPU's matrix unit and are not part of the port.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..ops import conv_kernel, front_kernel, rblock_kernel, upconv_kernel
from ..ops._conv_in import eff_affine
from .arch_dsl import LayerSpec, ModelSpec, parse_arch

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitive layers (NHWC in, NHWC out)
# ---------------------------------------------------------------------------

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad2d(x, pad: int, mode: str):
    if pad == 0:
        return x
    mode = "reflect" if mode == "reflect" else "replicate"
    return _nhwc(F.pad(_nchw(x), (pad, pad, pad, pad), mode=mode))


def conv2d(x, w, b, stride: int = 1, pad: int = 0):
    """Zero-padded conv in x's dtype (float32 without TF32); w OIHW."""
    with device_mod.float32_convs():
        y = F.conv2d(_nchw(x), w.to(x.dtype), None, stride, pad)
    return _nhwc(y) + b.to(x.dtype)


def conv_transpose2d(x, w, b, stride: int, pad: int, out_adjust: int):
    """Torch SpatialFullConvolution semantics: out = (in-1)*s - 2p + k + a.

    The stored kernel (OIHW here, HWIO in the JAX package) is pre-flipped:
    the JAX package lowers it as a stride-dilated correlation. The same
    result is F.conv_transpose2d with the kernel flipped back and its
    in/out axes swapped."""
    wt = w.to(x.dtype).flip(2, 3).transpose(0, 1)
    with device_mod.float32_convs():
        y = F.conv_transpose2d(_nchw(x), wt, None, stride, pad, out_adjust)
    return _nhwc(y) + b.to(x.dtype)


def _affine(x, es, eb):
    """x * es + eb per channel, in float32, rounded back to x's dtype."""
    return (x.float() * es + eb).to(x.dtype)


def _instance_eff(x, scale, bias, eps: float = 1e-5):
    """The instance norm's per-sample, per-channel (scale, bias) pair, each
    (N, 1, 1, C): float32 statistics, biased variance (E[x^2] - E[x]^2,
    clamped at 0)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    mean_sq = (xf * xf).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    es = torch.rsqrt(var + eps) * scale.float()
    eb = bias.float() - mean * es
    return es, eb


def instance_norm(x, scale, bias, eps: float = 1e-5):
    """Instance norm with learned affine; float32 statistics, biased
    variance (E[x^2] - E[x]^2, clamped at 0)."""
    return _affine(x, *_instance_eff(x, scale, bias, eps))


def upsample_nearest(x, scale: int):
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def shave(x, s: int):
    return x[:, s:-s, s:-s, :]


def _norm_eff(x, p, use_instance_norm: bool):
    """The norm's (scale, bias) pair, broadcastable against x (N, H, W, C)."""
    if use_instance_norm:
        return _instance_eff(x, p["scale"], p["bias"])
    # batch norm: stored running statistics when the checkpoint has them,
    # batch statistics otherwise
    if "running_mean" in p:
        mean = p["running_mean"].float()
        var = p["running_var"].float()
    else:
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), unbiased=False)
    es = torch.rsqrt(var + 1e-5) * p["scale"].float()
    eb = p["bias"].float() - mean * es
    return es, eb


def _norm_apply(x, p, use_instance_norm: bool):
    return _affine(x, *_norm_eff(x, p, use_instance_norm))


def _k4_conv(h, w, b, pad: int):
    """A block's 3x3 conv through kernel K4 when its input and output widths
    are multiples of 128, else conv2d (the JAX package's ``_block_conv`` with
    ``pallas_conv=True``): pad 1 is the SAME form, pad 0 the VALID form on an
    input the block padded or that shrinks."""
    if w.shape[0] % 128 or w.shape[1] % 128 or w.shape[2:] != (3, 3):
        return conv2d(h, w, b, 1, pad)
    if pad == 1:
        return conv_kernel.conv3x3(h.contiguous(), w, b)
    return conv_kernel.conv3x3_valid(h.contiguous(), w, b)


def _block_apply(x, p, layer: LayerSpec, use_in: bool, conv):
    """A conv or residual block, its 3x3 convs through `conv` (conv2d or K4)."""
    pt = layer.block_padding
    inner_pad = 1 if pt == "zero" else 0
    h = x
    if pt in ("reflect", "replicate"):
        h = _pad2d(h, 1, pt)
    h = conv(h, p["conv1"]["w"], p["conv1"]["b"], pad=inner_pad)
    h = torch.relu(_norm_apply(h, p["norm1"], use_in))
    if pt in ("reflect", "replicate"):
        h = _pad2d(h, 1, pt)
    h = conv(h, p["conv2"]["w"], p["conv2"]["b"], pad=inner_pad)
    h = _norm_apply(h, p["norm2"], use_in)
    if layer.kind != "res_block":
        return h
    skip = shave(x, 2) if pt in ("none", "reflect-start") else x
    return h + skip


def _layer(params, spec: ModelSpec, i: int, x, block_conv):
    """Layer i in PyTorch ops, a block's convs through `block_conv`; its norm, ReLU."""
    layer, name = spec.layers[i], f"layer{i:02d}"
    p = params.get(name)
    if layer.kind == "conv":
        if layer.pad_mode:
            x = _pad2d(x, (layer.ksize - 1) // 2, layer.pad_mode)
        x = conv2d(x, p["w"], p["b"], layer.stride, layer.pad)
    elif layer.kind == "full_conv":
        x = conv_transpose2d(x, p["w"], p["b"], layer.stride, layer.pad, layer.out_adjust)
    elif layer.kind == "upsample":
        x = upsample_nearest(x, layer.scale)
    else:
        x = _block_apply(x, p, layer, spec.use_instance_norm, block_conv)
    if layer.norm_after:
        x = _norm_apply(x, params[name + "_norm"], spec.use_instance_norm)
    return torch.relu(x) if layer.relu_after else x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_conv(gen, ksize, in_ch, out_ch):
    """U(-stdv, stdv) weights (OIHW) and bias, stdv = 1/sqrt(k*k*in)."""
    stdv = 1.0 / (ksize * ksize * in_ch) ** 0.5
    w = (torch.rand((out_ch, in_ch, ksize, ksize), generator=gen, device=gen.device)
         * 2 - 1) * stdv
    b = (torch.rand((out_ch,), generator=gen, device=gen.device) * 2 - 1) * stdv
    return {"w": w, "b": b}


def _init_norm(gen, ch, use_instance_norm: bool):
    if use_instance_norm:
        scale = torch.rand((ch,), generator=gen, device=gen.device)
    else:
        scale = torch.ones((ch,), device=gen.device)
    return {"scale": scale, "bias": torch.zeros((ch,), device=gen.device)}


def init_params(generator: torch.Generator, spec: ModelSpec,
                device=device_mod.DEFAULT) -> Params:
    """Random parameters with the JAX package's ``init_params`` tree and
    distributions, drawn from `generator` on its own device (its numbers
    differ from jax.random's) and placed on `device` (the card unless
    ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    params: Params = {}
    in_ch = spec.in_channels
    use_in = spec.use_instance_norm
    for i, layer in enumerate(spec.layers):
        name = f"layer{i:02d}"
        if layer.kind in ("conv", "full_conv"):
            params[name] = _init_conv(generator, layer.ksize, in_ch, layer.out_channels)
            in_ch = layer.out_channels
        elif layer.kind in ("conv_block", "res_block"):
            d = layer.out_channels
            params[name] = {
                "conv1": _init_conv(generator, 3, d, d),
                "norm1": _init_norm(generator, d, use_in),
                "conv2": _init_conv(generator, 3, d, d),
                "norm2": _init_norm(generator, d, use_in),
            }
            in_ch = d
        if layer.norm_after:
            params[name + "_norm"] = _init_norm(generator, in_ch, use_in)
    return to_device(params, dev)


def leaves(tree):
    """The tensors of a nested parameter dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def to_device(tree, dev):
    """A parameter tree with every leaf on `dev` (a leaf already there is
    kept, not copied)."""
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the plan: which path takes which layers
# ---------------------------------------------------------------------------

def _front_pattern(spec: ModelSpec) -> bool:
    """Layers 0-2 are [conv s1 SAME -> IN -> ReLU -> 3x3 s2 pad-1 conv -> IN
    -> ReLU -> 3x3 s2 pad-1 conv]: the JAX package's full-kernel front
    (``apply(fused_front="full")``) and its level-2 phase front."""
    ls = spec.layers
    if not spec.use_instance_norm or len(ls) < 3:
        return False
    l0, l1, l2 = ls[0], ls[1], ls[2]
    return (l0.kind == "conv" and l0.stride == 1 and l0.pad_mode is None
            and l0.pad == (l0.ksize - 1) // 2 and l0.norm_after and l0.relu_after
            and l1.kind == "conv" and l1.stride == 2 and l1.ksize == 3
            and l1.pad == 1 and l1.pad_mode is None
            and l1.norm_after and l1.relu_after
            and l2.kind == "conv" and l2.stride == 2 and l2.ksize == 3
            and l2.pad == 1 and l2.pad_mode is None)


def supports_phase_io(spec: ModelSpec) -> bool:
    """The JAX package's test for its phase-io architectures: K3's pattern and
    an input pad that is a multiple of 4. The port runs no phase layout; the
    CLI validates ``--phase_resident`` with it as the JAX CLI does."""
    return _front_pattern(spec) and spec.input_pad % 4 == 0


def folds_upsample(up: LayerSpec, conv: LayerSpec, cin: int) -> bool:
    """Whether K6 takes layer `up` with layer `conv` after it on `cin`
    channels: a nearest 2x upsample, then a stride-1 conv with zero padding
    (k - 1) / 2 of a shape that ``upconv_kernel.covers`` names."""
    return (up.kind == "upsample" and up.scale == 2
            and conv.kind == "conv" and conv.stride == 1 and conv.pad_mode is None
            and conv.ksize % 2 == 1 and conv.pad == (conv.ksize - 1) // 2
            and upconv_kernel.covers(conv.ksize, cin, conv.out_channels))


def _chain(spec: ModelSpec, n: int, h: int, w: int):
    """Indices of the first maximal run of VALID residual blocks (the JAX
    package's ``_fused_chain_idxs`` with ``fused_rblocks=True``) at batch 1
    and h x w larger than the chain's shrinking (4 px per block), else ()."""
    if not spec.use_instance_norm or n != 1:
        return ()
    run = []
    for i, layer in enumerate(spec.layers):
        if (layer.kind == "res_block" and layer.block_padding in ("none", "reflect-start")
                and not layer.norm_after and not layer.relu_after):
            run.append(i)
        elif run:
            break
    return tuple(run) if h > 4 * len(run) + 2 and w > 4 * len(run) + 2 else ()


def layer_plan(spec: ModelSpec, shape, dtype, fused: bool, start_at: int = 0,
               stop_after=None):
    """The steps of one :func:`apply` call, in order, for an input of
    `shape` (N, H, W, C: x as :func:`apply` takes it) in the compute `dtype`:
    a list of (path, the indices of the layers it takes):

      * "K3": layers 0-2 through the front conv kernel, at batch 1 on a
        padded H and W divisible by 4, when the call runs past layer 2. Layer
        2's norm and ReLU go into the first launch of a "K2" step right after
        it, else before the next step;
      * "K2": the residual chain (:func:`_chain`, sized after K3) through the
        chain conv kernel, when the call runs all of it;
      * "K6": an upsample and the conv after it (:func:`folds_upsample`)
        through the folded upsample conv kernel in float32, with the net's
        tanh when the conv is the last layer;
      * "K4": a block whose width is a multiple of 128, its 3x3 convs
        through the block conv kernel (:func:`_k4_conv`: a conv of other
        widths, such as a widening block's first, through conv2d);
      * "torch": one layer in PyTorch ops; "tanh": the net's output tanh.

    fused=False plans PyTorch ops only."""
    ls, last = spec.layers, len(spec.layers) - 1
    n, h, w, c = shape
    if not start_at:
        h, w = h + 2 * spec.input_pad, w + 2 * spec.input_pad
    plan, i = [], start_at
    if (fused and not start_at and n == 1 and h % 4 == 0 and w % 4 == 0
            and (stop_after is None or stop_after >= 3) and _front_pattern(spec)):
        plan.append(("K3", (0, 1, 2)))
        i, h, w, c = 3, h // 4, w // 4, ls[2].out_channels
    if stop_after is not None and stop_after < i:
        return plan
    end = last if stop_after is None else min(stop_after, last)
    chain = _chain(spec, n, h, w) if fused else ()
    while i <= end:
        layer = ls[i]
        if chain[:1] == (i,) and chain[-1] <= end:
            step = ("K2", chain)
        elif (fused and dtype == torch.float32 and i < end
              and folds_upsample(layer, ls[i + 1], c)):
            step = ("K6", (i, i + 1))
        elif (fused and layer.kind in ("conv_block", "res_block")
              and layer.out_channels % 128 == 0):
            step = ("K4", (i,))
        else:
            step = ("torch", (i,))
        plan.append(step)
        i, c = step[1][-1] + 1, ls[step[1][-1]].out_channels
    if end == last and plan[-1:] != [("K6", (last - 1, last))]:
        plan.append(("tanh", ()))         # a K6 launch that ends the net applies it
    return plan


# ---------------------------------------------------------------------------
# the kernel paths: front (K3), residual chain (K2), folded upsample (K6)
# ---------------------------------------------------------------------------

def front_layers(x, p0, layer0: LayerSpec, norm0, p1, norm1, p2):
    """Layers 0-2 through kernel K3, three launches on the logical grid.
    Layer 0's and layer 1's instance norm + ReLU are fused into the next
    launch's prologue from the previous launch's statistics.

    x: (1, H, W, C) (already input-padded). Returns (z, stats, count): z
    (1, H/4, W/4, C2) is layer 2's conv output BEFORE its norm/ReLU, stats
    its float32 [sum; sum of squares] per channel over count pixels — the
    caller fuses layer 2's norm into the residual chain's first launch."""
    h0 = x[0].contiguous()
    y1, st1 = front_kernel.same_conv(h0, p0["w"], p0["b"], 1, layer0.pad)
    eff1 = eff_affine(st1, norm0["scale"], norm0["bias"], y1.shape[0] * y1.shape[1])
    y2, st2 = front_kernel.same_conv(y1, p1["w"], p1["b"], 2, 1, eff=eff1, relu=True)
    eff2 = eff_affine(st2, norm1["scale"], norm1["bias"], y2.shape[0] * y2.shape[1])
    z, st3 = front_kernel.same_conv(y2, p2["w"], p2["b"], 2, 1, eff=eff2, relu=True)
    return z[None], st3, z.shape[0] * z.shape[1]


def fused_res_chain(params, x, idxs, pre_eff=None, pre_relu: bool = False):
    """A run of VALID residual blocks through kernel K2, two launches per
    block: conv1 (prologue: the previous block's norm2 affine + the
    residual add, emitting this block's input for the next skip) and conv2
    (prologue: norm1 affine + ReLU). Only the last block's output affine and
    skip run outside the kernel.

    x: (1, H, W, C) -> (1, H - 4k, W - 4k, C) for k blocks. pre_eff /
    pre_relu: the producer's pending instance-norm affine and ReLU (the
    front kernel hands over layer 2's raw output and statistics), fused into
    the first launch, whose prologue result becomes block 1's skip."""
    a = x[0].contiguous()
    y2 = eff2 = None
    for n, i in enumerate(idxs):
        p = params[f"layer{i:02d}"]
        w1, b1 = p["conv1"]["w"], p["conv1"]["b"]
        if n == 0:
            if pre_eff is not None or pre_relu:
                y1, st1, a = rblock_kernel.chain_conv(
                    a, w1, b1, eff=pre_eff, pre_relu=pre_relu, emit_input=True)
            else:
                y1, st1 = rblock_kernel.chain_conv(a, w1, b1)
        else:
            y1, st1, a = rblock_kernel.chain_conv(
                y2, w1, b1, eff=eff2, skip=a, emit_input=True)
        eff1 = eff_affine(st1, p["norm1"]["scale"], p["norm1"]["bias"],
                          y1.shape[0] * y1.shape[1])
        y2, st2 = rblock_kernel.chain_conv(
            y1, p["conv2"]["w"], p["conv2"]["b"], eff=eff1, pre_relu=True)
        eff2 = eff_affine(st2, p["norm2"]["scale"], p["norm2"]["bias"],
                          y2.shape[0] * y2.shape[1])
    hv, wv = y2.shape[0], y2.shape[1]
    out = _affine(y2, eff2[0], eff2[1]) + a[2:2 + hv, 2:2 + wv]
    return out[None]


def upsample_conv(params, spec: ModelSpec, i: int, x):
    """Layers i (a nearest 2x upsample, then its norm and ReLU) and i + 1 (a
    stride-1 zero-padded conv, then its norm and ReLU, or the net's tanh when
    it is the last layer) through kernel K6, one launch at x's resolution.
    A nearest upsample keeps each channel's statistics, so the upsample's
    norm is taken on x and fused with its ReLU into the launch's prologue;
    an instance norm after the conv takes its statistics from the launch's
    epilogue. x: (N, H, W, C) float32 -> (N, 2H, 2W, Cout)."""
    up, conv = spec.layers[i], spec.layers[i + 1]
    use_in = spec.use_instance_norm
    n, c = x.shape[0], x.shape[-1]
    eff = None
    if up.norm_after:
        es, eb = _norm_eff(x, params[f"layer{i:02d}_norm"], use_in)
        eff = torch.stack([es.expand(n, 1, 1, c).reshape(n, c),
                           eb.expand(n, 1, 1, c).reshape(n, c)], dim=1)
    last = i + 1 == len(spec.layers) - 1
    want_stats = conv.norm_after and use_in
    p = params[f"layer{i + 1:02d}"]
    y = upconv_kernel.upconv(x.contiguous(), p["w"], p["b"], eff=eff, relu=up.relu_after,
                             stats=want_stats,
                             tanh_scale=spec.tanh_constant if last else None)
    if want_stats:
        y, st = y
        nrm = params[f"layer{i + 1:02d}_norm"]
        e = eff_affine(st, nrm["scale"], nrm["bias"], y.shape[1] * y.shape[2])
        y = _affine(y, e[:, 0, None, None, :], e[:, 1, None, None, :])
    elif conv.norm_after:
        y = _norm_apply(y, params[f"layer{i + 1:02d}_norm"], use_in)
    return torch.relu(y) if conv.relu_after else y


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def apply(params: Params, spec: ModelSpec, x, *, dtype=None, stop_after=None,
          start_at: int = 0, fused=None):
    """Run the stylizer. x: (N, H, W, in_channels) NHWC in preprocessed (VGG)
    space; returns (N, H, W, 3) in VGG space (pre-deprocess), in the
    compute dtype.

    start_at=i resumes the net at layer i with x the activation after layer
    i-1 (input pad and the kernel front are skipped); stop_after=i returns
    the activation after layer i.

    fused: run the kernel paths that :func:`layer_plan` picks for x's shape
    and the compute dtype (K3, K2, K4, K6) where the architecture allows
    them. None = on for CUDA tensors, off for CPU tensors; True on a CPU
    tensor runs the kernels' plain versions (the CPU tests use that to check
    the wiring); False runs PyTorch ops only."""
    if dtype is not None:
        x = x.to(dtype)
    if fused is None:
        fused = x.is_cuda
    plan = layer_plan(spec, tuple(x.shape), x.dtype, fused, start_at, stop_after)
    if spec.input_pad and not start_at:
        x = _pad2d(x, spec.input_pad, "reflect")
    pending = None                      # layer 2's (norm affine, ReLU) after K3
    for path, idxs in plan:
        if pending and path != "K2":
            eff, relu = pending
            if eff is not None:
                x = _affine(x, eff[0], eff[1])
            x, pending = (torch.relu(x) if relu else x), None
        if path == "K3":
            x, st3, cnt = front_layers(x, params["layer00"], spec.layers[0], params["layer00_norm"],
                                       params["layer01"], params["layer01_norm"], params["layer02"])
            eff = None
            if spec.layers[2].norm_after:
                n2 = params["layer02_norm"]
                eff = eff_affine(st3, n2["scale"], n2["bias"], cnt)
            pending = (eff, spec.layers[2].relu_after)
        elif path == "K2":
            x = fused_res_chain(params, x, idxs, *(pending or (None, False)))
            pending = None
        elif path == "K6":
            x = upsample_conv(params, spec, idxs[0], x)
        elif path == "tanh":
            x = torch.tanh(x) * spec.tanh_constant
        else:
            x = _layer(params, spec, idxs[0], x, _k4_conv if path == "K4" else conv2d)
    return x


def build(arch: str = "canonical", in_channels: int = 7, **kw):
    """Convenience: (spec, init_fn, apply_fn); init_fn(generator,
    device=...) and apply_fn(params, x, **apply_kwargs)."""
    spec = parse_arch(arch, in_channels=in_channels, **kw)

    def init_fn(generator, device=device_mod.DEFAULT):
        return init_params(generator, spec, device)

    def apply_fn(params, x, **akw):
        return apply(params, spec, x, **akw)

    return spec, init_fn, apply_fn


def count_params(params: Params) -> int:
    return sum(count_params(v) if isinstance(v, dict) else int(v.numel())
               for v in params.values())


def reuse_split_plan(spec: ModelSpec):
    """(front_tap, resume_at, crop_per_side) for the engine's feature-reuse
    mode, or None when the arch does not support it (the JAX package's
    ``reuse_split_plan``).

    The split brackets the maximal contiguous run of residual blocks, the
    mid-net whose output-minus-input delta the reuse mode advects by
    low-resolution flow (video/engine.py). crop_per_side is how much the
    VALID blocks shave the feature grid (2 px per side per reflect-start or
    none block), i.e. how to align the front tap with the block output:
    f_blocks ~= shave(f_front, crop) + delta. front_tap must be >= 2."""
    idxs = [i for i, l in enumerate(spec.layers) if l.kind == "res_block"]
    if not idxs or idxs != list(range(idxs[0], idxs[-1] + 1)):
        return None
    if idxs[0] - 1 < 2:
        return None
    crop = sum(2 for i in idxs
               if spec.layers[i].block_padding in ("none", "reflect-start"))
    return idxs[0] - 1, idxs[-1] + 1, crop
