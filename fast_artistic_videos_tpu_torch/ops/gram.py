"""Gram matrix (channel covariance) for style features, NHWC — counterpart
of ``fast_artistic_videos_tpu/ops/gram.py``.

Matches nn.GramMatrix (fast_artistic_video/GramMatrix.lua:31-51):
G = X · Xᵀ / (C*H*W) with X the (C, H*W) feature matrix. The JAX version
runs the product at ``Precision.HIGHEST``; here it is one ``torch.matmul``
in the features' dtype with TF32 off (``core.device.float32_convs``).
Autograd gives the backward.
"""

from __future__ import annotations

import torch

from ..core import device as device_mod


def gram_matrix(feats, normalize: bool = True):
    """feats: (N, H, W, C) or (H, W, C) -> (N, C, C) or (C, C)."""
    single = feats.ndim == 3
    if single:
        feats = feats[None]
    n, h, w, c = feats.shape
    x = feats.reshape(n, h * w, c)
    with device_mod.float32_convs():
        gram = torch.matmul(x.transpose(1, 2), x)
    if normalize:
        gram = gram / (c * h * w)
    return gram[0] if single else gram


def mean_aggregate(feats):
    """Spatial mean aggregation for the 'mean' style target type
    (StyleLoss.lua:19-22): (N, H, W, C) -> (N, C)."""
    single = feats.ndim == 3
    if single:
        feats = feats[None]
    out = feats.mean(dim=(1, 2))
    return out[0] if single else out
