"""Cube-face geometry for spherical (360°) video stylization.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/video/vr_geometry.py``
(the maps are numpy; the rotations take numpy arrays or torch tensors, and
``equirect_to_faces`` warps with the port's ``ops.warp``).

Generates the warp maps and blend masks used by the VR driver — absolute
pixel-offset flow fields consumed by ops.warp.bilinear_warp, matching the
reference generators (fast_artistic_video/vr_helper.lua):

  * perspective_warp_map_{left,right,top,bottom}(...) — re-project a
    neighboring cube face's border strip into this face's frame
    (vr_helper.lua:3-92). Unmapped pixels carry a huge sentinel offset so
    the warp samples zero there.
  * cube_to_equirectangular_map(...) — sampling map from a horizontal strip
    of 6 cube faces to an equirectangular panorama (vr_helper.lua:95-184).

Our flow arrays are (H, W, 2) float32 with channels (dx, dy); the reference
stores (dy, dx) — values are identical, channel order swapped. Formulas are
evaluated with the reference's 1-based pixel coordinates to keep numerical
parity, then written at 0-based indices (offsets are translation-invariant).

Cube layout (vr driver): faces 1..6 arranged
        2
    3 6 4 5
        1
with processing order (6, 1, 2, 5, 3, 4) (fast_artistic_video_vr.lua:96-103).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

SENTINEL = 99999.0


def _strip_width(size: int, oversize: float) -> float:
    """The reference's derived half-size of the projected border strip
    (vr_helper.lua:6-8)."""
    width = size / 2 / ((2 * oversize + size) / size)
    max_resize = (width + oversize) / width
    return width - (max_resize - 1) / max_resize * oversize


def perspective_warp_map_left(
    height: int, crop_w: int, orig_width: int,
    oversize_h: Optional[float] = None, oversize_w: Optional[float] = None,
) -> np.ndarray:
    """Map placing a perspective-projected neighbor-border strip at the
    RIGHT side of the target frame (vr_helper.lua:3-23 — the 'left' naming
    follows the reference: the neighbor is to the left of this face)."""
    if oversize_h is None:
        oversize_h = crop_w / 2
    if oversize_w is None:
        oversize_w = crop_w / 2
    width = _strip_width(height, oversize_h)
    flow = np.full((height, orig_width, 2), SENTINEL, np.float32)
    mid_y = height / 2
    # NOTE: the reference's Lua numeric for runs x over *fractional* values
    # width-crop_w+1, width-crop_w+2, ... (width itself is a float); only the
    # derived column index is integral (vr_helper.lua:13-19).
    for k in range(1, crop_w + 1):
        x = (width - crop_w) + k
        rf_h = (x + oversize_h) / width
        rf_w = (x + oversize_w) / width
        xi = k + orig_width - crop_w  # 1-based col
        for y in range(1, height + 1):
            flow[y - 1, xi - 1, 1] = (mid_y - y) * (-1 / rf_h + 1)
            flow[y - 1, xi - 1, 0] = (
                (width - x - oversize_w) * (rf_w - 1) / rf_w - orig_width + crop_w
            )
    return flow


def perspective_warp_map_right(
    height: int, crop_w: int, orig_width: int,
    oversize_h: Optional[float] = None, oversize_w: Optional[float] = None,
) -> np.ndarray:
    if oversize_h is None:
        oversize_h = crop_w / 2
    if oversize_w is None:
        oversize_w = crop_w / 2
    width = _strip_width(height, oversize_h)
    flow = np.full((height, orig_width, 2), SENTINEL, np.float32)
    mid_y = height / 2
    for x in range(1, crop_w + 1):
        rf_h = (width - x + oversize_h) / width
        rf_w = (width - x + oversize_w) / width
        for y in range(1, height + 1):
            flow[y - 1, x - 1, 1] = (mid_y - y) * (-1 / rf_h + 1)
            flow[y - 1, x - 1, 0] = (
                -(x - oversize_w) * (rf_w - 1) / rf_w + orig_width - crop_w
            )
    return flow


def perspective_warp_map_top(
    width: int, crop_h: int, orig_height: int,
    oversize_w: Optional[float] = None, oversize_h: Optional[float] = None,
) -> np.ndarray:
    if oversize_h is None:
        oversize_h = crop_h / 2
    if oversize_w is None:
        oversize_w = crop_h / 2
    height = _strip_width(width, oversize_w)
    flow = np.full((orig_height, width, 2), SENTINEL, np.float32)
    mid_x = width / 2
    for k in range(1, crop_h + 1):
        y = (height - crop_h) + k  # fractional, see note in ..._left
        rf_w = (y + oversize_w) / height
        rf_h = (y + oversize_h) / height
        yi = k + orig_height - crop_h
        for x in range(1, width + 1):
            flow[yi - 1, x - 1, 1] = (
                (height - y - oversize_h) * (rf_h - 1) / rf_h - orig_height + crop_h
            )
            flow[yi - 1, x - 1, 0] = (mid_x - x) * (-1 / rf_w + 1)
    return flow


def perspective_warp_map_bottom(
    width: int, crop_h: int, orig_height: int,
    oversize_w: Optional[float] = None, oversize_h: Optional[float] = None,
) -> np.ndarray:
    if oversize_h is None:
        oversize_h = crop_h / 2
    if oversize_w is None:
        oversize_w = crop_h / 2
    height = _strip_width(width, oversize_w)
    flow = np.full((orig_height, width, 2), SENTINEL, np.float32)
    mid_x = width / 2
    for y in range(1, crop_h + 1):
        rf_w = (height - y + oversize_w) / height
        rf_h = (height - y + oversize_h) / height
        for x in range(1, width + 1):
            flow[y - 1, x - 1, 1] = (
                -(y - oversize_h) * (rf_h - 1) / rf_h + orig_height - crop_h
            )
            flow[y - 1, x - 1, 0] = (mid_x - x) * (-1 / rf_w + 1)
    return flow


def cube_to_equirectangular_map(
    w_plus_overlap: int, h_plus_overlap: int, overlap_w: float, overlap_h: float,
    out_w: int, out_h: int,
) -> np.ndarray:
    """Offset map from the 6-face horizontal strip (f, l, r, b, u, d order,
    each w_plus_overlap wide) to an (out_h, out_w) equirectangular image
    (vr_helper.lua:95-184, itself after https://stackoverflow.com/a/34427087)."""
    face_w = w_plus_overlap - overlap_w
    face_h = h_plus_overlap - overlap_h
    flow = np.zeros((out_h, out_w, 2), np.float32)
    for j in range(out_h):
        v = 1 - (j / out_h)
        theta = v * math.pi
        for i in range(out_w):
            u = i / out_w
            phi = u * 2 * math.pi
            x = math.sin(phi) * math.sin(theta) * -1
            y = math.cos(theta)
            z = math.cos(phi) * math.sin(theta) * -1
            a = max(abs(x), abs(y), abs(z))
            xa, ya, za = x / a, y / a, z / a
            if xa == 1:        # right
                xp = (((za + 1) / 2) - 1) * face_w
                xo = 2 * w_plus_overlap
                yp = ((ya + 1) / 2) * face_h
            elif xa == -1:     # left
                xp = ((za + 1) / 2) * face_w
                xo = 1 * w_plus_overlap
                yp = ((ya + 1) / 2) * face_h
            elif ya == 1:      # up
                xp = ((xa + 1) / 2) * face_w
                xo = 5 * w_plus_overlap
                yp = (((za + 1) / 2) - 1) * face_h
            elif ya == -1:     # down
                xp = ((xa + 1) / 2) * face_w
                xo = 4 * w_plus_overlap
                yp = ((za + 1) / 2) * face_h
            elif za == 1:      # front
                xp = ((xa + 1) / 2) * face_w
                xo = 0
                yp = ((ya + 1) / 2) * face_h
            else:              # back (za == -1)
                xp = (((xa + 1) / 2) - 1) * face_w
                xo = 3 * w_plus_overlap
                yp = ((ya + 1) / 2) * face_h
            xp = abs(xp) + xo + overlap_w / 2
            yp = abs(yp) + overlap_h / 2
            flow[j, i, 1] = yp - j
            flow[j, i, 0] = xp - i
    return flow


# ---------------------------------------------------------------------------
# rotations (fast_artistic_video_vr.lua:130-144) on HWC arrays
# ---------------------------------------------------------------------------

def rotate90(img):
    """Reference rotate90: transpose spatial dims then reverse rows. Takes a
    numpy array or a torch tensor and returns the same type (a copy)."""
    if isinstance(img, torch.Tensor):
        return img.transpose(0, 1).flip(0)
    return img.swapaxes(0, 1)[::-1].copy()


def rotate_minus90(img):
    if isinstance(img, torch.Tensor):
        return img.transpose(0, 1).flip(1)
    return img.swapaxes(0, 1)[:, ::-1].copy()


def rotate180(img):
    if isinstance(img, torch.Tensor):
        return img.flip(0, 1)
    return img[::-1, ::-1].copy()


# ---------------------------------------------------------------------------
# equirectangular -> cube faces (the transformVRVideo.sh / Transform360 step)
# ---------------------------------------------------------------------------

# NOTE the forward map's "Up" branch writes strip slot 5 and "Down"
# slot 4 (vr_helper.lua:139-150), i.e. the strip order is f,l,r,b,DOWN,UP —
# so driver face 3 (strip slot 4) is the down face and face 4 the up face.
_SLOT_OF_FACE = {6: "front", 1: "left", 2: "right", 5: "back", 3: "down", 4: "up"}


def equirect_to_face_map(
    slot: str, hplus: int, wplus: int, overlap_w: float, overlap_h: float,
    eq_h: int, eq_w: int,
) -> np.ndarray:
    """Offset map sampling one overlapping cube face from an equirectangular
    image — the exact inverse of the per-slot branches of
    cube_to_equirectangular_map (vr_helper.lua:95-184), so faces produced
    with these maps reconstruct the panorama through the VR driver's
    equirect output path.

    Returns (hplus, wplus, 2) offsets into an equirect image that has been
    horizontally wrap-padded by EQUIRECT_WRAP_PAD columns on each side (the
    bilinear taps of seam pixels need the wrap).
    """
    face_w = wplus - overlap_w
    face_h = hplus - overlap_h
    rr, cc = np.mgrid[0:hplus, 0:wplus].astype(np.float64)
    u_f = (cc - overlap_w / 2) / face_w      # in [-ow/2/fw, 1 + ...]
    v_f = (rr - overlap_h / 2) / face_h
    a = 2 * u_f - 1
    b = 2 * v_f - 1
    one = np.ones_like(a)
    if slot == "front":
        x, y, z = a, b, one
    elif slot == "left":
        x, y, z = -one, b, a
    elif slot == "right":
        x, y, z = one, b, -a
    elif slot == "back":
        x, y, z = -a, b, -one
    elif slot == "up":
        x, y, z = a, one, -b
    elif slot == "down":
        x, y, z = a, -one, b
    else:
        raise ValueError(slot)
    n = np.sqrt(x * x + y * y + z * z)
    theta = np.arccos(np.clip(y / n, -1.0, 1.0))
    phi = np.mod(np.arctan2(-x, -z), 2 * math.pi)
    i_e = phi / (2 * math.pi) * eq_w + EQUIRECT_WRAP_PAD
    j_e = (1 - theta / math.pi) * eq_h
    flow = np.zeros((hplus, wplus, 2), np.float32)
    flow[..., 0] = i_e - cc
    flow[..., 1] = j_e - rr
    return flow


EQUIRECT_WRAP_PAD = 4


def equirect_to_faces(equi: np.ndarray, hplus: int, wplus: int,
                      overlap_w: float, overlap_h: float):
    """Split an equirectangular frame (H, W, C) into the 6 overlapping cube
    faces in the VR driver's file numbering (1..6), including the storage
    rotation of the up/down faces (the equirect output places rot180 of faces
    3 and 4, fast_artistic_video_vr.lua:543)."""
    from ..ops import warp as warp_ops

    eq_h, eq_w = equi.shape[:2]
    padded = np.concatenate(
        [equi[:, -EQUIRECT_WRAP_PAD:], equi, equi[:, :EQUIRECT_WRAP_PAD]], axis=1
    )
    faces = {}
    for number, slot in _SLOT_OF_FACE.items():
        m = equirect_to_face_map(slot, hplus, wplus, overlap_w, overlap_h, eq_h, eq_w)
        img = warp_ops.bilinear_warp(torch.from_numpy(np.ascontiguousarray(padded)),
                                     torch.from_numpy(m)).numpy()
        if slot in ("up", "down"):
            img = rotate180(img)
        faces[number] = img
    return faces
