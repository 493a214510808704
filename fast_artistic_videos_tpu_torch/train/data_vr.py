"""Synthetic VR training source — counterpart of
``fast_artistic_videos_tpu/train/data_vr.py``: cube-face border priors made
from single images (DataLoader_video_fake.lua:192-272, mode 'vr').

For a random side (left / right / top / bottom):
  1. ``map_first`` perspective-projects the image as a neighbouring cube
     face would see it (crop 70, oversize 0), and a thin border strip is cut
     from it: the already stylized neighbour ("frame 1");
  2. ``map_second`` (crop 64, oversize 0, mirrored onto the strip's side)
     is the "flow" that places the strip's stylization on this face's
     border: an absolute-offset map over the whole training image that
     samples the strip (source and output sizes differ);
  3. certainty = ones warped through map_second (nonzero where the strip
     lands).

The geometry works on 384x384 source images (:249-253); inputs of another
size are resized. Both warps are the exact gather
(``ops.warp.bilinear_warp`` with no band), on the CPU; the batch is numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import warp
from ..video import vr_geometry as vr
from . import data as data_mod

_GEOM_SIZE = 384


def _maps(side: str, train_hw: Tuple[int, int]):
    H = W = _GEOM_SIZE
    h, w = train_hw
    if side == "left":
        first = vr.perspective_warp_map_left(H, 70, W, oversize_h=0)
        second = vr.perspective_warp_map_right(h, 64, w, 0, 0).copy()
        second[..., 0] += -w + 64  # mirror onto the strip (ref :209-211)
        crop = (slice(64, H - 64), slice(W - 65, W - 1))
    elif side == "right":
        first = vr.perspective_warp_map_right(H, 70, W, oversize_h=0)
        second = vr.perspective_warp_map_left(h, 64, w, 0, 0)
        crop = (slice(64, H - 64), slice(0, 64))
    elif side == "top":
        first = vr.perspective_warp_map_top(W, 70, H, oversize_w=0)
        second = vr.perspective_warp_map_bottom(w, 64, h, 0, 0).copy()
        second[..., 1] += -h + 64
        crop = (slice(H - 65, H - 1), slice(64, W - 64))
    else:  # bottom
        first = vr.perspective_warp_map_bottom(W, 70, H, oversize_w=0)
        second = vr.perspective_warp_map_top(w, 64, h, 0, 0)
        crop = (slice(0, 64), slice(64, W - 64))
    return first, second, crop


class VRMaps:
    """The four sides' maps at one training size, built on first use (the
    JAX package keeps a module-level cache; here the trainer owns one)."""

    def __init__(self):
        self._maps = {}

    def get(self, side: str, train_hw: Tuple[int, int]):
        key = (side, tuple(train_hw))
        got = self._maps.get(key)
        if got is None:
            got = self._maps[key] = _maps(side, tuple(train_hw))
        return got


def _warp_np(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    return warp.bilinear_warp(torch.from_numpy(np.ascontiguousarray(img)),
                              torch.from_numpy(np.ascontiguousarray(flow))).numpy()


def vr_batch(images: np.ndarray, rng: np.random.Generator,
             train_hw: Tuple[int, int], maps: VRMaps | None = None) -> data_mod.Batch:
    """images: (N, H, W, 3) RGB [0, 1]. Returns (imgs, flows, certs) with
    imgs[0] the neighbour's border strip and imgs[1] the full frame."""
    n = images.shape[0]
    h, w = train_hw
    if min(h, w) <= 128:
        # the 64-wide border geometry degenerates: the reference trains vr
        # at >= 256 (train_video.lua:36)
        raise ValueError(f"vr source needs train_img_size > 128, got {train_hw}")
    side = ("left", "right", "top", "bottom")[int(rng.integers(0, 4))]
    first, second, crop = (maps or VRMaps()).get(side, train_hw)

    pre = data_mod.preprocess(images)
    pre384 = pre
    if pre.shape[1:3] != (_GEOM_SIZE, _GEOM_SIZE):
        pre384 = data_mod._resize_bilinear(pre, _GEOM_SIZE, _GEOM_SIZE)

    imgs1 = _warp_np(pre384, first)
    strip = imgs1[:, crop[0], crop[1]].copy()

    flow = np.broadcast_to(second[None], (n,) + second.shape).astype(np.float32)

    cert_full = np.ones(pre384.shape[:3] + (1,), np.float32)
    cert_strip = cert_full[:, crop[0], crop[1]].copy()
    cert = _warp_np(cert_strip, flow)

    imgs2 = pre
    if pre.shape[1:3] != (h, w):
        imgs2 = data_mod._resize_bilinear(pre, h, w)
    return [strip, imgs2], [flow], [cert.astype(np.float32)]
