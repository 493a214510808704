"""Training losses as pure functions — counterpart of
``fast_artistic_videos_tpu/train/losses.py``.

Reference mapping:
  * PerceptualCriterion (PerceptualCriterion.lua) — mode-switched loss
    *layers* mutated between capture/loss modes become
    :func:`style_targets` (one capture pass) + :func:`perceptual_loss`
    (pure evaluation). Style aggregation: gram or spatial mean
    (StyleLoss.lua:16-24); all criterions are size-averaged MSE like Torch's
    MSECriterion defaults.
  * pixel losses L2/L1/SmoothL1 (train_video.lua:116-126).

These are forward functions; autograd gives their gradients, and the JAX
version's ``stop_gradient`` is ``.detach()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models import vgg
from ..ops.gram import gram_matrix, mean_aggregate


@dataclasses.dataclass(frozen=True)
class PerceptualConfig:
    style_layers: Tuple[int, ...] = (4, 9, 16, 23)
    style_weights: Tuple[float, ...] = (10.0,) * 4
    content_layers: Tuple[int, ...] = (16,)
    content_weights: Tuple[float, ...] = (1.0,)
    agg_type: str = "gram"  # 'gram' | 'mean'
    loss_type: str = "L2"   # 'L2' | 'SmoothL1' (probe criterion, PerceptualCriterion.lua:25)
    deepdream_layers: Tuple[int, ...] = ()
    deepdream_weights: Tuple[float, ...] = ()
    deepdream_max_grad: float = 100.0
    # feature extractor: 'vgg' (reference semantics, PerceptualCriterion.lua)
    # or 'rgb-pyramid' (deterministic multi-scale RGB statistics; layer
    # indices are pyramid levels)
    extractor: str = "vgg"

    @property
    def all_layers(self) -> Tuple[int, ...]:
        return tuple(
            sorted(set(self.style_layers) | set(self.content_layers)
                   | set(self.deepdream_layers))
        )


def _aggregate(feats, agg_type: str):
    return gram_matrix(feats) if agg_type == "gram" else mean_aggregate(feats)


def extract_features_rgb_pyramid(params, x, taps):
    """Parameter-free loss features: at pyramid level L (tap index = L),
    the 2^L-avg-pooled image concatenated with its horizontal and vertical
    finite differences (9 channels). `params` is accepted and ignored
    (extractor interface parity with models.vgg.extract_features)."""
    taps = tuple(int(t) for t in taps)
    feats = {}
    if not taps:
        return feats
    cur = x
    for lvl in range(max(taps) + 1):
        if lvl > 0:
            cur = F.avg_pool2d(cur.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if lvl in taps:
            dx = cur[:, :, 1:] - cur[:, :, :-1]
            dy = cur[:, 1:, :] - cur[:, :-1, :]
            feats[lvl] = torch.cat([cur[:, :-1, :-1], dx[:, :-1], dy[:, :, :-1]], -1)
    return feats


def _extract(cfg: PerceptualConfig):
    if cfg.extractor == "rgb-pyramid":
        return extract_features_rgb_pyramid
    return vgg.extract_features


def style_targets(vgg_params, style_img_pre, cfg: PerceptualConfig) -> List[torch.Tensor]:
    """Capture pass over the style image ((1, H, W, 3), VGG space) —
    PerceptualCriterion:setStyleTarget."""
    feats = _extract(cfg)(vgg_params, style_img_pre, cfg.style_layers)
    return [_aggregate(feats[l], cfg.agg_type) for l in cfg.style_layers]


def _probe_crit(kind: str, a, b):
    """Size-averaged probe criterion (StyleLoss/ContentLoss loss_type)."""
    if kind == "SmoothL1":
        d = (a - b).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
    return ((a - b) ** 2).mean()


def deepdream_loss(feats, strength: float, max_grad: float = 100.0):
    """Activation-maximization term whose gradient reproduces
    nn.DeepDreamLoss.updateGradInput (DeepDreamLoss.lua:22-27):
    grad = -strength * clamp(x, -max_grad, max_grad), i.e. the gradient of
    -strength * sum(huber_m(x)) with m = max_grad."""
    a = feats.abs()
    huber = torch.where(a <= max_grad, 0.5 * feats * feats,
                        max_grad * a - 0.5 * max_grad ** 2)
    return -strength * huber.sum()


def perceptual_loss(
    vgg_params,
    x,
    content_target,
    style_tgts: Sequence[torch.Tensor],
    cfg: PerceptualConfig,
):
    """x, content_target: (N, H, W, 3) VGG space. Returns (loss, per_layer)
    where per_layer has 'style-<l>' / 'content-<l>' entries (the reference's
    style_losses/content_losses tables, PerceptualCriterion.lua:137-151)."""
    feats = _extract(cfg)(vgg_params, x, cfg.all_layers)
    target_feats = _extract(cfg)(
        vgg_params, content_target.detach(), cfg.content_layers
    ) if cfg.content_layers else {}
    per_layer: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, wgt, tgt in zip(cfg.style_layers, cfg.style_weights, style_tgts):
        agg = _aggregate(feats[l], cfg.agg_type)
        tgt = tgt.detach()
        if agg.ndim == tgt.ndim + 1:  # broadcast single style target over batch
            tgt = tgt[None]
        loss = wgt * _probe_crit(cfg.loss_type, agg, tgt)
        per_layer[f"style-{l}"] = loss
        total = total + loss
    for l, wgt in zip(cfg.content_layers, cfg.content_weights):
        loss = wgt * _probe_crit(cfg.loss_type, feats[l], target_feats[l].detach())
        per_layer[f"content-{l}"] = loss
        total = total + loss
    for l, wgt in zip(cfg.deepdream_layers, cfg.deepdream_weights):
        loss = deepdream_loss(feats[l], wgt, cfg.deepdream_max_grad)
        per_layer[f"deepdream-{l}"] = loss
        total = total + loss
    return total, per_layer


def pixel_loss(kind: str, a, b):
    """Size-averaged pixel criterion (train_video.lua:116-126)."""
    d = a - b
    if kind == "L2":
        return (d * d).mean()
    if kind == "L1":
        return d.abs().mean()
    if kind == "SmoothL1":
        ad = d.abs()
        return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()
    raise ValueError(f"unknown pixel loss {kind!r}")
