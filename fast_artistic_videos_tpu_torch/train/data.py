"""Training data sources — counterpart of
``fast_artistic_videos_tpu/train/data.py``.

Real video batches come from the HDF5 that ``cli/make_video_dataset.py``
writes (the reference's make_video_dataset.py:70-80 layout:
``/{train,val}/frames1`` (N, seq, 3, H, W) uint8, ``/flow``
(N, seq-1, 2, H, W) float32 with (u, v) channels, ``/cert``
(N, seq-1, H, W) uint8).

Synthetic sources make temporally consistent tuples from single images,
with analytically exact flow (DataLoader_video_fake.lua):
  * shift        — a camera pan: constant integer flow, certainty zero in
                   the band the pan reveals (:114-144)
  * zoom_out     — crop-and-rescale zoom with a linear flow ramp (:146-180)
  * single_image — black prior, everything occluded (:182-190)
  * vr           — ``train.data_vr``.

Every source returns ``(imgs, flows, certs)``: imgs a list of num_steps+1
float32 numpy arrays (N, H, W, 3) in VGG space, flows num_steps (N, H, W, 2)
(dx, dy), certs num_steps (N, H, W, 1) in [0, 1]. The batches are numpy,
drawn from the caller's ``np.random.Generator``, so one seed gives the JAX
package's batches; the resizes and the VGG preprocessing run in torch on
the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..flow.estimator import resize_bilinear
from ..ops.preprocess import vgg_preprocess

Batch = Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]


def _resize_bilinear(imgs: np.ndarray, h: int, w: int) -> np.ndarray:
    """``jax.image.resize(..., "bilinear")`` of (N, H, W, C) numpy to
    (N, h, w, C): half-pixel centres, antialiased when shrinking."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32))
    return resize_bilinear(x, (h, w)).numpy()


def preprocess(images: np.ndarray) -> np.ndarray:
    """RGB [0, 1] numpy -> VGG space (float32 numpy)."""
    return vgg_preprocess(torch.from_numpy(np.ascontiguousarray(images, np.float32))).numpy()


def _border_cert(n: int, h: int, w: int, dx: int, dy: int) -> np.ndarray:
    """Certainty with zeroed bands where the shift reveals new content
    (DataLoader_video_fake.lua:130-139)."""
    cert = np.ones((n, h, w, 1), np.float32)
    if dx > 0:
        cert[:, :, w - dx:] = 0.0
    elif dx < 0:
        cert[:, :, :-dx] = 0.0
    if dy > 0:
        cert[:, h - dy:, :] = 0.0
    elif dy < 0:
        cert[:, :-dy, :] = 0.0
    return cert


def shift_batch(images: np.ndarray, num_steps: int, rng: np.random.Generator) -> Batch:
    """images: (N, H, W, 3) RGB [0, 1]. A simulated pan of num_steps frames."""
    n, h, w = images.shape[:3]
    dx = int(rng.integers(-16, 16))
    dy = int(rng.integers(-16, 16))
    offs = 16
    big = preprocess(_resize_bilinear(images, h + offs * num_steps, w + offs * num_steps))
    imgs = []
    for i in range(num_steps + 1):
        y0 = max(-dy * (num_steps - i), 0) + max(dy * i, 0)
        x0 = max(-dx * (num_steps - i), 0) + max(dx * i, 0)
        imgs.append(big[:, y0:y0 + h, x0:x0 + w])
    flow = np.zeros((n, h, w, 2), np.float32)
    flow[..., 0] = dx
    flow[..., 1] = dy
    cert = _border_cert(n, h, w, dx, dy)
    return imgs, [flow] * num_steps, [cert] * num_steps


def zoom_out_batch(images: np.ndarray, num_steps: int, rng: np.random.Generator) -> Batch:
    n, h, w = images.shape[:3]
    dx = int(rng.integers(-16, 16))
    dy = int(rng.integers(-16, 16))
    pre = preprocess(images)
    imgs = []
    for i in range(num_steps + 1):
        y0 = max(-dy * (num_steps - i), 0)
        x0 = max(-dx * (num_steps - i), 0)
        hh = h - abs(dy * (num_steps - i))
        ww = w - abs(dx * (num_steps - i))
        crop = pre[:, y0:y0 + hh, x0:x0 + ww]
        imgs.append(_resize_bilinear(crop, h, w))
    # linear flow ramp (the reference's approximation, :169-178)
    fy = np.linspace(-max(-dy, 0), max(dy, 0), h, dtype=np.float32)[:, None]
    fx = np.linspace(-max(-dx, 0), max(dx, 0), w, dtype=np.float32)[None, :]
    flow = np.zeros((n, h, w, 2), np.float32)
    flow[..., 0] = fx
    flow[..., 1] = fy
    cert = _border_cert(n, h, w, dx, dy)
    return imgs, [flow] * num_steps, [cert] * num_steps


def single_image_batch(images: np.ndarray, num_steps: int, rng=None) -> Batch:
    """Black prior, everything occluded (:182-190). Always one step."""
    n, h, w = images.shape[:3]
    return (
        [np.zeros((n, h, w, 3), np.float32), preprocess(images)],
        [np.zeros((n, h, w, 2), np.float32)],
        [np.zeros((n, h, w, 1), np.float32)],
    )


def shard_range(n: int, num_shards: int, shard_index: int) -> Tuple[int, int]:
    """Contiguous row range [lo, hi) of shard `shard_index` of an n-row
    dataset. One process reads the whole dataset (num_shards 1, shard_index
    0); the fields stay for the data-parallel trainer (ROADMAP slice F)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    return shard_index * n // num_shards, (shard_index + 1) * n // num_shards


class H5ImageSource:
    """Single-image HDF5 (MS-COCO style): /{train2014,val2014}/images
    (N, 3, H, W) uint8, feeding the synthetic sources
    (DataLoader_video_fake.lua:36-39). With num_shards > 1 the source
    serves its shard's contiguous rows only."""

    def __init__(self, path: str, batch_size: int, out_hw: Optional[Tuple[int, int]] = None,
                 max_train: int = 0, num_shards: int = 1, shard_index: int = 0):
        import h5py

        self.f = h5py.File(path, "r")
        self.batch_size = batch_size
        self.out_hw = out_hw
        self.paths = {"train": "/train2014/images", "val": "/val2014/images"}
        sizes = {k: self.f[v].shape[0] for k, v in self.paths.items()}
        if max_train:
            sizes["train"] = min(sizes["train"], max_train)
        self.ranges = {k: shard_range(n, num_shards, shard_index)
                       for k, n in sizes.items()}
        self.cursor = {k: lo for k, (lo, _) in self.ranges.items()}

    def close(self) -> None:
        self.f.close()

    def reset(self, split: str) -> None:
        self.cursor[split] = self.ranges[split][0]

    def next_images(self, split: str) -> np.ndarray:
        """The next batch_size images of `split`, (N, H, W, 3) float32 RGB
        [0, 1], resized to out_hw; the cursor wraps before a short batch."""
        lo, hi = self.ranges[split]
        start = self.cursor[split]
        if start + self.batch_size > hi:
            start = lo
        end = start + self.batch_size
        raw = self.f[self.paths[split]][start:end]
        self.cursor[split] = lo if end >= hi else end
        imgs = raw.astype(np.float32).transpose(0, 2, 3, 1) / 255.0
        if self.out_hw and imgs.shape[1:3] != tuple(self.out_hw):
            imgs = _resize_bilinear(imgs, *self.out_hw)
        return imgs


class H5VideoSource:
    """Real video HDF5 source (DataLoader_video_real.lua). With
    num_shards > 1 the source serves its shard's contiguous rows only."""

    def __init__(self, path: str, batch_size: int, max_train: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        import h5py

        self.f = h5py.File(path, "r")
        self.batch_size = batch_size
        sizes = {k: self.f[f"/{k}/frames1"].shape[0] for k in ("train", "val")}
        if max_train:
            sizes["train"] = min(sizes["train"], max_train)
        self.ranges = {k: shard_range(n, num_shards, shard_index)
                       for k, n in sizes.items()}
        self.cursor = {k: lo for k, (lo, _) in self.ranges.items()}

    def close(self) -> None:
        self.f.close()

    def reset(self, split: str) -> None:
        self.cursor[split] = self.ranges[split][0]

    def set_cursor_from_iteration(self, split: str, iteration: int) -> None:
        """Deterministic resume (DataLoader_video_real.lua:58-61), within
        this source's shard."""
        lo, hi = self.ranges[split]
        n = hi - lo
        usable = n - (n % self.batch_size) + self.batch_size
        self.cursor[split] = lo + ((iteration - 1) * self.batch_size) % usable

    def get_batch(self, split: str, num_steps: int) -> Batch:
        lo, hi = self.ranges[split]
        start = self.cursor[split]
        if start + self.batch_size > hi:
            start = lo
        end = start + self.batch_size
        frames = self.f[f"/{split}/frames1"][start:end]   # (n, seq, 3, H, W) uint8
        flow = self.f[f"/{split}/flow"][start:end]        # (n, seq-1, 2, H, W) (u, v)
        cert = self.f[f"/{split}/cert"][start:end]        # (n, seq-1, H, W) uint8
        self.cursor[split] = lo if end >= hi else end

        max_steps = frames.shape[1] - 1
        if num_steps > max_steps:
            raise ValueError(f"h5 stores {max_steps}-step sequences, requested {num_steps}")
        imgs = [preprocess(frames[:, i].astype(np.float32).transpose(0, 2, 3, 1) / 255.0)
                for i in range(num_steps + 1)]
        flows = [flow[:, i].transpose(0, 2, 3, 1).astype(np.float32) for i in range(num_steps)]
        certs = [(cert[:, i].astype(np.float32) / 255.0)[..., None] for i in range(num_steps)]
        return imgs, flows, certs


SYNTHETIC_SOURCES = {
    "shift": shift_batch,
    "zoom_out": zoom_out_batch,
    "single_image": single_image_batch,
}
