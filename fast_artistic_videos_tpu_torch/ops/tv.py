"""Total-variation regularizer as a pure loss function — counterpart of
``fast_artistic_videos_tpu/ops/tv.py``.

The reference's TotalVariation layer (fast_artistic_video/TotalVariation.lua:
19-35) is the identity forward with a hand-written backward, which is the
gradient of

    L(x) = 0.5 * strength * sum(x_diff^2 + y_diff^2)

with x_diff = x[:, :-1, :-1] - x[:, :-1, 1:] and
     y_diff = x[:, :-1, :-1] - x[:, 1:, :-1];

autograd differentiates this scalar.
"""

from __future__ import annotations


def tv_loss(x, strength: float = 1.0):
    """x: (..., H, W, C). Returns 0.5 * strength * the sum of squared
    differences."""
    x_diff = x[..., :-1, :-1, :] - x[..., :-1, 1:, :]
    y_diff = x[..., :-1, :-1, :] - x[..., 1:, :-1, :]
    return 0.5 * strength * ((x_diff * x_diff).sum() + (y_diff * y_diff).sum())
