"""Optical flow estimation with the compact PWC-style network — counterpart
of ``fast_artistic_videos_tpu/flow/estimator.py``: inference (feature
pyramid, coarse-to-fine refinement with a radius-3 cost volume, the
context head, the streaming ``prep`` / ``refine_pair`` entry points and
their batch forms ``prep_batch`` / ``refine_pair_batch`` for the VR
driver's six cube faces) and the training half (``init_params``,
``init_context``, ``add_context``, ``apply``, ``apply_multiscale``,
``save_params``; ``flow/train.py`` trains through ``apply_multiscale``).

Its convs are plain ``F.conv2d`` (the JAX package leaves them to XLA), in
float32 without TF32 (``core.device.float32_convs``); the
feature warps go through the banded warp, kernel K1 on CUDA, except in
``apply_multiscale``, the training entry, which takes the banded form's
differentiable plain version (K1 has no backward). Activations
are NHWC at every function boundary; flow is (N, H, W, 2) (dx, dy) float32
in pixels of the level it lives on.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..models import registry
from ..models.checkpoint import params_from_numpy, params_to_numpy
from ..ops import warp as warp_ops

# (out_channels per level), finest first. Level l runs at stride 2^(l+1).
PYRAMID_CHANNELS = (16, 32, 64, 96)
COST_RADIUS = 3
ESTIMATOR_CHANNELS = (96, 64, 32)
CONTEXT_CHANNELS = (64, 64, 48)
CONTEXT_DILATIONS = (1, 2, 4)
WARP_BAND = 8           # feature-warp band (level flows stay a few pixels)
STRIDE = 2 ** len(PYRAMID_CHANNELS)

Params = Dict[str, Dict[str, torch.Tensor]]


def _same_pads(n: int, k: int, stride: int, dilation: int):
    """XLA "SAME" padding (lo, hi) of one axis: asymmetric at stride 2 on
    even sizes (lo 0, hi 1)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def _conv(params, name, x, stride=1, relu=True, dilation=1):
    p = params[name]
    w = p["w"].to(x.dtype)
    k = w.shape[2]
    ph = _same_pads(x.shape[1], k, stride, dilation)
    pw = _same_pads(x.shape[2], k, stride, dilation)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    with device_mod.float32_convs():
        y = F.conv2d(xc, w, None, stride, 0, dilation).permute(0, 2, 3, 1)
    y = y + p["b"].to(x.dtype)
    return F.leaky_relu(y, 0.1) if relu else y


def _init_conv(gen, k, cin, cout):
    """He-normal weights (OIHW), zero bias: the JAX package's law."""
    scale = (2.0 / (k * k * cin)) ** 0.5
    return {"w": torch.randn((cout, cin, k, k), generator=gen, device=gen.device) * scale,
            "b": torch.zeros((cout,), device=gen.device)}


def init_params(generator: torch.Generator, context: bool = False,
                device=device_mod.DEFAULT) -> Params:
    """Random estimator weights drawn from `generator` on its device (the
    JAX package's tree and law, not its draws), on `device` (the card
    unless ``device="cpu"``); with the context head if `context`."""
    dev = device_mod.resolve(device)
    params: Params = {}
    cin = 3
    for lvl, cout in enumerate(PYRAMID_CHANNELS):
        params[f"pyr{lvl}_a"] = _init_conv(generator, 3, cin, cout)
        params[f"pyr{lvl}_b"] = _init_conv(generator, 3, cout, cout)
        cin = cout
    cost_ch = (2 * COST_RADIUS + 1) ** 2
    for lvl in range(len(PYRAMID_CHANNELS)):
        cin_est = cost_ch + PYRAMID_CHANNELS[lvl] + 2
        for i, cout in enumerate(ESTIMATOR_CHANNELS):
            params[f"est{lvl}_{i}"] = _init_conv(generator, 3, cin_est, cout)
            cin_est = cout
        params[f"est{lvl}_out"] = _init_conv(generator, 3, cin_est, 2)
    if context:
        params.update(init_context(generator, device=generator.device))
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}


def init_context(generator: torch.Generator, device=device_mod.DEFAULT) -> Params:
    """The context head's parameters alone (CONTEXT_CHANNELS). Its output
    conv is zero, so grafting it onto trained weights changes nothing until
    it is fine-tuned (:func:`add_context`)."""
    dev = device_mod.resolve(device)
    params: Params = {}
    cin = ESTIMATOR_CHANNELS[-1] + 2  # the finest estimator features + flow
    for i, cout in enumerate(CONTEXT_CHANNELS):
        params[f"ctx_{i}"] = _init_conv(generator, 3, cin, cout)
        cin = cout
    params["ctx_out"] = {"w": torch.zeros((2, cin, 3, 3), device=generator.device),
                         "b": torch.zeros((2,), device=generator.device)}
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}


def add_context(params: Params, generator: torch.Generator) -> Params:
    """`params` with a (no-op) context head grafted on, on the parameters'
    device: the fine-tune entry for upgrading trained weights in place."""
    if "ctx_out" in params:
        return params
    out = dict(params)
    out.update(init_context(generator, device=params["pyr0_a"]["w"].device))
    return out


def _pyramid(params, img):
    feats = []
    x = img
    for lvl in range(len(PYRAMID_CHANNELS)):
        x = _conv(params, f"pyr{lvl}_a", x, stride=2)
        x = _conv(params, f"pyr{lvl}_b", x, stride=1)
        feats.append(x)
    return feats


def extract_pyramid(params, img):
    """Mean-normalized feature pyramid (finest first) of an image batch
    (N, H, W, 3) RGB [0, 1]."""
    return _pyramid(params, img - 0.45)


def _cost_volume(f1, f2w, radius: int):
    """Local correlation over (2r+1)^2 static shifts. f*: (N, H, W, C)."""
    n, h, w, c = f1.shape
    pad = F.pad(f2w, (0, 0, radius, radius, radius, radius))
    norm = 1.0 / c
    rows = []
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            shifted = pad[:, dy:dy + h, dx:dx + w, :]
            rows.append((f1 * shifted).sum(dim=-1) * norm)
    return torch.stack(rows, dim=-1)


def _upsample2_flow(flow):
    return flow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0


def refine(params, f1s, f2s, collect: bool = False, skip_finest: int = 0,
           init_flow=None, run_levels: int = None, differentiable: bool = False):
    """Coarse-to-fine refinement from two feature pyramids. Returns the flow
    at pyramid-input resolution, or with collect the per-level estimates
    (coarsest first, level pixel units).

    skip_finest=k stops k levels early and upsamples the coarser estimate.
    init_flow + run_levels start at level (skip_finest + run_levels - 1)
    from init_flow (that level's pixel units) instead of zeros.
    differentiable: the feature warps take the banded form's plain version
    (autograd) instead of kernel K1."""
    flow = None
    outs: List[torch.Tensor] = []
    top = len(PYRAMID_CHANNELS)
    if run_levels is not None:
        top = skip_finest + run_levels
    for lvl in reversed(range(skip_finest, top)):
        f1, f2 = f1s[lvl], f2s[lvl]
        if flow is None and init_flow is not None:
            flow = init_flow.float()
            f2w = warp_ops.bilinear_warp(f2, flow, band=WARP_BAND,
                                         differentiable=differentiable)
        elif flow is None:
            flow = torch.zeros(f1.shape[:3] + (2,), device=f1.device)
            f2w = f2
        else:
            flow = _upsample2_flow(flow)
            f2w = warp_ops.bilinear_warp(f2, flow, band=WARP_BAND,
                                         differentiable=differentiable)
        cost = F.leaky_relu(_cost_volume(f1, f2w, COST_RADIUS), 0.1)
        x = torch.cat([cost, f1, flow.to(f1.dtype)], dim=-1)
        for i in range(len(ESTIMATOR_CHANNELS)):
            x = _conv(params, f"est{lvl}_{i}", x)
        flow = flow + _conv(params, f"est{lvl}_out", x, relu=False).float()
        if lvl == 0 and "ctx_out" in params:
            # context head: dilated convs over the finest estimator
            # features + flow, predicting a flow residual
            cx = torch.cat([x, flow.to(x.dtype)], dim=-1)
            for i, dil in enumerate(CONTEXT_DILATIONS):
                cx = _conv(params, f"ctx_{i}", cx, dilation=dil)
            flow = flow + _conv(params, "ctx_out", cx, relu=False).float()
        if collect:
            outs.append(flow)
    if collect:
        return outs
    for _ in range(1 + skip_finest):
        flow = _upsample2_flow(flow)
    return flow


def apply(params: Params, img1, img2):
    """img1, img2: (N, H, W, 3) RGB [0, 1], H and W multiples of STRIDE.
    The flow (N, H, W, 2) (dx, dy) in pixels mapping img1's pixels to
    their positions in img2. Forward only: the feature warps launch K1 on
    the card."""
    return refine(params, extract_pyramid(params, img1), extract_pyramid(params, img2))


def apply_multiscale(params: Params, img1, img2):
    """The training entry: the flow estimate of every pyramid level
    (coarsest first), in that level's pixel units. Differentiable: the
    feature warps take the banded form's plain version, not K1."""
    return refine(params, extract_pyramid(params, img1), extract_pyramid(params, img2),
                  collect=True, differentiable=True)


def resize_bilinear(x, size):
    """``jax.image.resize(..., "bilinear")`` of (H, W, C) or (N, H, W, C)
    over the two spatial axes: half-pixel centres, antialiased when
    shrinking, computed in float32 and returned in x's dtype."""
    single = x.ndim == 3
    xb = x[None] if single else x
    h, w = xb.shape[1], xb.shape[2]
    y = F.interpolate(xb.float().permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False,
                      antialias=size[0] < h or size[1] < w)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    return y[0] if single else y


def _pad_edge(x, hp: int, wp: int):
    """Edge replication of (..., H, W, C) to (..., hp, wp, C)."""
    h, w = x.shape[-3], x.shape[-2]
    if (hp, wp) == (h, w):
        return x
    rows = torch.arange(hp, device=x.device).clamp(max=h - 1)
    cols = torch.arange(wp, device=x.device).clamp(max=w - 1)
    return x.index_select(-3, rows).index_select(-2, cols)


def _scaled(h: int, w: int, flow_scale: float):
    if flow_scale != 1.0:
        return int(round(h * flow_scale)), int(round(w * flow_scale))
    return h, w


class FlowEstimator:
    """Streaming front end of the estimator: per-frame pyramids (``prep``)
    and both flow directions of a pair from two cached pyramids
    (``refine_pair``), on ``device`` (the card unless ``device="cpu"``)."""

    # the streaming providers may replay this step from CUDA graphs
    capturable = True

    def __init__(self, params: Params, dtype=torch.float32, device=device_mod.DEFAULT):
        self.params = params
        self.device = device_mod.resolve(device)
        self._dtype = dtype

    @torch.no_grad()
    def prep(self, frame, flow_scale: float = 1.0):
        """Feature pyramid (a tuple, finest first, batch 1) of one frame
        (H, W, 3) RGB uint8 or [0, 1] float, estimated at flow_scale
        resolution (resize, then edge-pad to a multiple of 16)."""
        return self.prep_batch(frame[None], flow_scale)

    @torch.no_grad()
    def prep_batch(self, frames, flow_scale: float = 1.0):
        """Batched :meth:`prep`: frames (N, H, W, 3) -> the pyramid tuple
        with a leading batch axis (the VR driver's six faces at once)."""
        h, w = frames.shape[1], frames.shape[2]
        hs, ws = _scaled(h, w, flow_scale)
        hp, wp = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
        x = frames.to(self.device)
        x = x.to(self._dtype) / 255.0 if x.dtype == torch.uint8 else x.to(self._dtype)
        if (hs, ws) != (h, w):
            x = resize_bilinear(x, (hs, ws))
        x = _pad_edge(x, hp, wp)
        return tuple(extract_pyramid(self.params, x))

    @torch.no_grad()
    def refine_pair(self, feats_a, feats_b, out_hw, flow_scale: float = 1.0,
                    with_lowres: bool = False, coarse_backward: bool = False,
                    fast_check: bool = False):
        """Both flow directions of a pair: a->b (the warp flow) and b->a
        (the cross-check).

        fast_check: the b->a direction starts at pyramid level 1 from the
        negated, self-warped a->b estimate and refines that level only.
        coarse_backward: the b->a direction stops one level early.

        with_lowres=False: (flow_ab, flow_ba, maxabs_ab), flows (H, W, 2)
        at out_hw in full-resolution pixels. with_lowres=True:
        (flow_ab_full, flow_ab_low, flow_ba_low, maxabs_low), the low flows
        at estimation resolution in its pixel units. maxabs is a 0-d
        device tensor."""
        h, w = out_hw
        hs, ws = _scaled(h, w, flow_scale)
        fa, fb = list(feats_a), list(feats_b)

        def up(flow):
            if (hs, ws) != (h, w):
                flow = resize_bilinear(flow, (h, w)) / flow_scale
            return flow

        if not fast_check:
            low_ab = refine(self.params, fa, fb)[0, :hs, :ws]
            low_ba = refine(self.params, fb, fa,
                            skip_finest=1 if coarse_backward else 0)[0, :hs, :ws]
        else:
            outs = refine(self.params, fa, fb, collect=True)
            low_ab = _upsample2_flow(outs[-1])[0, :hs, :ws]
            fab1 = outs[len(PYRAMID_CHANNELS) - 2]   # level-1 estimate
            init = -warp_ops.bilinear_warp(fab1, -fab1, band=WARP_BAND)
            low_ba = refine(self.params, fb, fa, init_flow=init, run_levels=1,
                            skip_finest=1)[0, :hs, :ws]
        maxabs = low_ab.abs().max()
        if with_lowres:
            return up(low_ab), low_ab, low_ba, maxabs
        return up(low_ab), up(low_ba), maxabs


    @torch.no_grad()
    def refine_pair_batch(self, feats_a, feats_b, out_hw, flow_scale: float = 1.0,
                          fast_check: bool = False):
        """Both flow directions of N independent pairs at once (the batch
        axis of :meth:`refine_pair` with ``with_lowres=True``). Returns
        (flow_ab_full (N, H, W, 2), flow_ab_low, flow_ba_low, maxabs_low),
        maxabs_low a 0-d device tensor over the whole batch (one band bucket
        serves every stream)."""
        h, w = out_hw
        hs, ws = _scaled(h, w, flow_scale)
        fa, fb = list(feats_a), list(feats_b)
        if fast_check:
            outs = refine(self.params, fa, fb, collect=True)
            low_ab = _upsample2_flow(outs[-1])[:, :hs, :ws]
            fab1 = outs[len(PYRAMID_CHANNELS) - 2]   # level-1 estimate
            init = -warp_ops.bilinear_warp(fab1, -fab1, band=WARP_BAND)
            low_ba = refine(self.params, fb, fa, init_flow=init, run_levels=1,
                            skip_finest=1)[:, :hs, :ws]
        else:
            low_ab = refine(self.params, fa, fb)[:, :hs, :ws]
            low_ba = refine(self.params, fb, fa)[:, :hs, :ws]
        full = low_ab
        if (hs, ws) != (h, w):
            full = resize_bilinear(low_ab, (h, w)) / flow_scale
        return full, low_ab, low_ba, low_ab.abs().max()


def save_params(path: str, params: Params) -> None:
    """Write estimator weights as .npz with ``name/leaf`` keys in the JAX
    package's layout (HWIO kernels), which both packages' ``load_params``
    read."""
    flat = {f"{name}/{leaf}": v for name, leaves in params_to_numpy(params).items()
            for leaf, v in leaves.items()}
    np.savez(path, **flat)


def load_params(path: str, device=device_mod.DEFAULT) -> Params:
    """Estimator weights from .npz (``name/leaf`` keys) on `device` (the
    card unless ``device="cpu"``); ``bundled`` is the JAX package's in-tree
    checkpoint (``assets/flow_pwclite.npz``)."""
    if path == "bundled":
        path = registry.bundled_flow_weights()
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            name, leaf = key.rsplit("/", 1)
            tree.setdefault(name, {})[leaf] = z[key]
    return params_from_numpy(tree, device)
