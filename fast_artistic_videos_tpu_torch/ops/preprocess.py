"""VGG pre/deprocessing — counterpart of
``fast_artistic_videos_tpu/ops/preprocess.py``, same constants.

  * vgg: RGB [0,1] (..., H, W, 3) -> BGR*255 - mean(103.939, 116.779, 123.68)

Arithmetic runs in the input's dtype, as in the JAX version.
"""

from __future__ import annotations

import torch

# Means are in *BGR* channel order (preprocess.lua:46).
VGG_MEAN_BGR = (103.939, 116.779, 123.68)


def _const(values, x):
    return torch.tensor(values, dtype=x.dtype, device=x.device)


def vgg_preprocess(img):
    """RGB [0,1] (..., H, W, 3) -> VGG space (BGR, *255, mean-subtracted)."""
    bgr = img.flip(-1)
    return bgr * _const(255.0, img) - _const(VGG_MEAN_BGR, img)


def vgg_deprocess(img):
    """VGG space -> RGB [0,1]. Exact inverse of :func:`vgg_preprocess`."""
    bgr = (img + _const(VGG_MEAN_BGR, img)) / _const(255.0, img)
    return bgr.flip(-1)
