"""Supervised training of the PWC-lite flow estimator on synthetic warps —
counterpart of ``fast_artistic_videos_tpu/flow/train.py``.

Sample an image, draw a smooth random motion field (affine plus a
low-frequency residual, optionally split by a motion discontinuity),
synthesize frame1 = warp(frame2, field) and supervise with the exact field:
the analytic ground truth of the reference's fake data loader
(DataLoader_video_fake.lua:114-180), extended to dense fields. The loss is
the multiscale endpoint error (L1) against the downsampled ground truth,
coarse levels weighted down (PWC-Net).

The host-side sampling (fields, procedural and natural images, the seeds)
is numpy from the caller's seed, as in the JAX package, so one seed draws
the same data; its bicubic resizes are ``video.driver_video``'s (Keys'
a = -0.5, ``jax.image.resize``'s "bicubic"). The gradient pass runs
through ``estimator.apply_multiscale`` (autograd; the banded feature warp's
plain version, since K1 has no backward) inside
``core.device.float32_convs``; Adam is ``torch.optim.Adam``. The
forward-only users, :func:`evaluate_heldout` and the streaming provider,
run ``estimator.apply``, whose feature warps launch K1 on the card.
"""

from __future__ import annotations

import functools
import glob
import os
import zlib

import numpy as np
import torch

from ..core import device as device_mod
from ..models.checkpoint import ASSETS
from ..ops import warp as warp_ops
from ..video.driver_video import resize_bicubic_to
from . import consistency, estimator


def _bicubic_np(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """``jax.image.resize(a, (h, w, ...), "bicubic")`` of an (H, W) or
    (H, W, C) numpy array, float32."""
    x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    x = x[..., None] if x.ndim == 2 else x
    y = resize_bicubic_to(x, (h, w)).numpy()
    return y[..., 0] if a.ndim == 2 else y


def random_flow_field(rng: np.random.Generator, h: int, w: int,
                      max_shift: float = 12.0) -> np.ndarray:
    """Smooth random motion: affine plus blurred noise, |flow| <~ 2 max_shift."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    tx, ty = rng.uniform(-max_shift, max_shift, 2)
    rot = rng.uniform(-0.05, 0.05)
    scale = rng.uniform(-0.08, 0.08)
    fx = tx + scale * (xs - cx) - rot * (ys - cy)
    fy = ty + scale * (ys - cy) + rot * (xs - cx)
    coarse = rng.normal(0, max_shift / 4, (4, 4, 2)).astype(np.float32)
    return np.stack([fx, fy], -1) + _bicubic_np(coarse, h, w)


def random_flow_field_discontinuous(rng: np.random.Generator, h: int, w: int,
                                    max_shift: float = 12.0) -> np.ndarray:
    """Two independently moving regions split by a smooth random boundary:
    a motion discontinuity with real occlusions when warped."""
    fa = random_flow_field(rng, h, w, max_shift)
    fb = random_flow_field(rng, h, w, max_shift)
    fine = _bicubic_np(rng.normal(size=(3, 3)).astype(np.float32), h, w)
    mask = (fine > np.median(fine)).astype(np.float32)[..., None]
    return fa * mask + fb * (1.0 - mask)


def _warp_np(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """The exact gather of numpy arrays, on the CPU."""
    return warp_ops.bilinear_warp(torch.from_numpy(np.ascontiguousarray(img, np.float32)),
                                  torch.from_numpy(np.ascontiguousarray(flow, np.float32))
                                  ).numpy()


def make_pair(images: np.ndarray, rng: np.random.Generator,
              p_discontinuous: float = 0.3, max_shift: float = 12.0):
    """images: (N, H, W, 3) numpy. Returns numpy (img1, img2, gt_flow) with
    img1(x) = img2(x + gt(x)); a p_discontinuous share of the fields has
    piecewise motion with occluding discontinuities."""
    n, h, w = images.shape[:3]
    flows = np.stack([
        random_flow_field_discontinuous(rng, h, w, max_shift)
        if rng.random() < p_discontinuous else
        random_flow_field(rng, h, w, max_shift)
        for _ in range(n)
    ]).astype(np.float32)
    img2 = np.asarray(images, np.float32)
    return _warp_np(img2, flows), img2, flows


def _downsample_flow(flow, factor: int):
    n, h, w, _ = flow.shape
    f = flow.reshape(n, h // factor, factor, w // factor, factor, 2).mean(dim=(2, 4))
    return f / factor


def multiscale_loss(params, img1, img2, gt_flow):
    """The weighted L1 of every level's estimate against the block-mean
    ground truth (tensors on one device); differentiable."""
    outs = estimator.apply_multiscale(params, img1, img2)
    weights = [0.32, 0.08, 0.02, 0.01][: len(outs)][::-1]  # coarse .. fine
    total = 0.0
    n_levels = len(estimator.PYRAMID_CHANNELS)
    for i, flow_l in enumerate(outs):  # coarsest first
        factor = 2 ** (n_levels - i)
        total = total + weights[i] * (flow_l - _downsample_flow(gt_flow, factor)).abs().mean()
    return total


def _trainable(params, device):
    """A copy of `params` on `device` whose leaves require grad (the
    caller's tensors are left alone, as the JAX functions leave theirs)."""
    return {k: {n: t.detach().to(device).clone().requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}


def _frozen(params):
    return {k: {n: t.detach() for n, t in v.items()} for k, v in params.items()}


def _step(params, optimizer, img1, img2, gt):
    """One Adam step on the multiscale loss; returns the loss (a 0-d tensor)."""
    with device_mod.float32_convs():
        loss = multiscale_loss(params, img1, img2, gt)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    return loss.detach()


def train_flow(image_source, iterations: int = 2000, learning_rate: float = 1e-4,
               seed: int = 0, params=None, log_fn=print, log_every: int = 50,
               device=device_mod.DEFAULT):
    """image_source: callable -> (N, H, W, 3) float32 numpy batches (H, W
    multiples of the pyramid stride). Trains on `device` (the card unless
    ``device="cpu"``) and returns the trained parameters."""
    dev = device_mod.resolve(device)
    if params is None:
        params = estimator.init_params(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev)
    params = _trainable(params, dev)
    optimizer = torch.optim.Adam([t for v in params.values() for t in v.values()],
                                 lr=learning_rate)
    rng = np.random.default_rng(seed)
    for it in range(1, iterations + 1):
        img1, img2, gt = make_pair(image_source(), rng)
        loss = _step(params, optimizer, *(torch.from_numpy(a).to(dev) for a in (img1, img2, gt)))
        if it % log_every == 0:
            log_fn(f"flow iter {it}/{iterations} loss {float(loss):.4f}")
    return _frozen(params)


def epe(flow, gt) -> float:
    """Mean endpoint error in pixels (numpy or CPU tensors)."""
    return float(np.mean(np.linalg.norm(np.asarray(flow) - np.asarray(gt), axis=-1)))


# ---------------------------------------------------------------------------
# procedural and natural images; device-resident synthetic training
# ---------------------------------------------------------------------------

def random_texture_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A procedural training image: octaves of smooth noise plus sharp-edged
    coloured shapes, (h, w, 3) float32 in [0, 1]."""
    img = np.zeros((h, w, 3), np.float32)
    for cells in (4, 8, 24):
        coarse = rng.normal(size=(cells, cells, 3)).astype(np.float32)
        img += _bicubic_np(coarse, h, w) * (1.5 / cells ** 0.5)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(rng.integers(4, 9)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h / 16, h / 3), rng.uniform(w / 16, w / 3)
        th = rng.uniform(0, np.pi)
        ca, sa = np.cos(th), np.sin(th)
        u = ((xs - cx) * ca + (ys - cy) * sa) / rx
        v = (-(xs - cx) * sa + (ys - cy) * ca) / ry
        inside = (u * u + v * v < 1.0) if rng.random() < 0.5 else (
            (np.abs(u) < 1.0) & (np.abs(v) < 1.0))
        img[inside] = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def _resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Plain numpy bilinear resize with half-pixel centres (point-sampled
    when shrinking), as the JAX package's sampler."""
    sh, sw = img.shape[:2]
    ys = (np.arange(h, dtype=np.float32) + 0.5) * (sh / h) - 0.5
    xs = (np.arange(w, dtype=np.float32) + 0.5) * (sw / w) - 0.5
    y0 = np.clip(np.floor(ys), 0, sh - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, sw - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _natural_sources():
    """The bundled natural-statistics fixtures (the JAX package's
    assets/eval/*.png), read once."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(ASSETS, "eval", "*.png")))
    if not paths:
        raise FileNotFoundError(f"no natural fixtures in {os.path.join(ASSETS, 'eval')}")
    return tuple(np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0 for p in paths)


def natural_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A natural-statistics image: a random scaled crop, with flips, of the
    bundled photographic and terrain fixtures, (h, w, 3) float32."""
    sources = _natural_sources()
    src = sources[int(rng.integers(len(sources)))]
    sh, sw = src.shape[:2]
    ch = int(rng.integers(max(h // 2, 16), min(sh, max(h, h // 2 + 17))))
    cw = int(rng.integers(max(w // 2, 16), min(sw, max(w, w // 2 + 17))))
    y0 = int(rng.integers(0, sh - ch + 1))
    x0 = int(rng.integers(0, sw - cw + 1))
    img = src[y0:y0 + ch, x0:x0 + cw]
    if rng.random() < 0.5:
        img = img[:, ::-1]
    if rng.random() < 0.25:
        img = img[::-1]
    if img.shape[:2] != (h, w):
        img = _resize_bilinear_np(np.ascontiguousarray(img), h, w)
    return np.ascontiguousarray(img).astype(np.float32)


def natural_image_augmented(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A training-side natural sample: :func:`natural_image` with
    photometric jitter (gamma, per-channel gain, brightness) and, at times,
    a two-crop composite across a smooth random boundary."""
    img = natural_image(rng, h, w)
    if rng.random() < 0.4:
        other = natural_image(rng, h, w)
        fine = _bicubic_np(rng.normal(size=(3, 3)).astype(np.float32), h, w)
        mask = (fine > np.median(fine)).astype(np.float32)[..., None]
        img = img * mask + other * (1.0 - mask)
    img = img ** np.float32(rng.uniform(0.6, 1.6))
    img = img * rng.uniform(0.7, 1.3, 3).astype(np.float32)
    img = img + np.float32(rng.uniform(-0.15, 0.15))
    lo, hi = img.min(), img.max()
    if hi - lo > 1e-6 and (lo < 0.0 or hi > 1.0):
        img = (img - lo) / (hi - lo)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def fields_from_seeds(size: int, affine, coarse, bnd, affine_b, flags):
    """A batch of (size, size, 2) flow fields from per-sample seeds
    (tensors on one device): affine (N, 4) = (tx, ty, rot, scale), a
    (N, 4, 4, 2) low-frequency residual and, where flags (N,) > 0.5, a
    second affine (N, 4) on the far side of a boundary, the bicubic
    upsampled (N, 3, 3) seed thresholded at its median (the JAX package's
    ``_field_from_seeds``, batched)."""
    dev = affine.device
    c = (size - 1) / 2
    ys = (torch.arange(size, dtype=torch.float32, device=dev) - c).view(1, size, 1)
    xs = (torch.arange(size, dtype=torch.float32, device=dev) - c).view(1, 1, size)

    def affine_field(a):
        tx, ty, rot, sc = (a[:, k].view(-1, 1, 1) for k in range(4))
        return torch.stack([tx + sc * xs - rot * ys, ty + sc * ys + rot * xs], -1)

    fine = resize_bicubic_to(coarse, (size, size))
    fa = affine_field(affine) + fine
    fb = affine_field(affine_b) + fine
    b = resize_bicubic_to(bnd[..., None], (size, size))[..., 0]
    med = torch.quantile(b.reshape(b.shape[0], -1), 0.5, dim=1)   # numpy's median
    mask = (b > med.view(-1, 1, 1)).float()[..., None]
    disc = fa * mask + fb * (1.0 - mask)
    return torch.where(flags.view(-1, 1, 1, 1) > 0.5, disc, fa)


def train_flow_synthetic(
    iterations: int = 12000,
    batch_size: int = 8,
    size: int = 192,
    learning_rate: float = 2e-4,
    seed: int = 0,
    params=None,
    pool: int = 128,
    max_shift: float = 12.0,
    p_discontinuous: float = 0.3,
    log_fn=print,
    log_every: int = 200,
    lr_decay_at: float = 0.7,
    natural_frac: float = 0.0,
    natural_augment: bool = False,
    device=device_mod.DEFAULT,
):
    """Self-contained flow training on `device` (the card unless
    ``device="cpu"``): a device-resident pool of procedural images
    (natural_frac of it from the bundled natural fixtures, with jitter if
    natural_augment) and every iteration's field seeds drawn up front from
    `seed`, as the JAX function draws them; the learning rate drops 10x
    from iteration lr_decay_at * iterations. Returns the trained
    parameters."""
    dev = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = estimator.init_params(torch.Generator(device=dev).manual_seed(seed),
                                       device=dev)
    params = _trainable(params, dev)
    optimizer = torch.optim.Adam([t for v in params.values() for t in v.values()],
                                 lr=learning_rate)
    n_nat = int(round(pool * natural_frac))
    nat_src = natural_image_augmented if natural_augment else natural_image
    pool_imgs = [nat_src(rng, size, size) for _ in range(n_nat)]
    pool_imgs += [random_texture_image(rng, size, size) for _ in range(pool - n_nat)]
    rng.shuffle(pool_imgs)
    images = torch.from_numpy(np.stack(pool_imgs)).to(dev)

    n, T = batch_size, iterations

    def _affines(count):
        out = np.empty((count, 4), np.float32)
        out[:, 0:2] = rng.uniform(-max_shift, max_shift, (count, 2))
        out[:, 2] = rng.uniform(-0.05, 0.05, count)
        out[:, 3] = rng.uniform(-0.08, 0.08, count)
        return out

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    seeds = dict(
        idx=up(rng.integers(0, pool, size=(T, n))),
        affine=up(_affines(T * n).reshape(T, n, 4)),
        affine_b=up(_affines(T * n).reshape(T, n, 4)),
        coarse=up(rng.normal(0, max_shift / 4, (T, n, 4, 4, 2)).astype(np.float32)),
        bnd=up(rng.normal(size=(T, n, 3, 3)).astype(np.float32)),
        flags=up((rng.random((T, n)) < p_discontinuous).astype(np.float32)),
    )
    decay_from = int(iterations * lr_decay_at)
    loss = None
    for it in range(iterations):
        img2 = images[seeds["idx"][it]]
        fields = fields_from_seeds(size, seeds["affine"][it], seeds["coarse"][it],
                                   seeds["bnd"][it], seeds["affine_b"][it], seeds["flags"][it])
        img1 = warp_ops.bilinear_warp(img2, fields)
        for group in optimizer.param_groups:
            group["lr"] = learning_rate * (0.1 if it >= decay_from else 1.0)
        loss = _step(params, optimizer, img1, img2, fields)
        if (it + 1) % log_every == 0 or it + 1 == iterations:
            log_fn(f"flow iter {it + 1}/{iterations} loss {float(loss):.4f}")
    return _frozen(params)


# ---------------------------------------------------------------------------
# held-out evaluation protocols
# ---------------------------------------------------------------------------

EVAL_PROTOCOLS = ("smooth", "large", "discont")


def _protocol_field(name: str, rng: np.random.Generator, h: int, w: int):
    if name == "smooth":          # in-distribution magnitudes
        return random_flow_field(rng, h, w, max_shift=12)
    if name == "large":           # larger displacements than training
        return random_flow_field(rng, h, w, max_shift=20)
    if name == "discont":         # occluding piecewise motion
        return random_flow_field_discontinuous(rng, h, w, max_shift=12)
    raise ValueError(f"unknown protocol {name!r}")


@torch.no_grad()
def evaluate_heldout(params, size: int = 192, n_cases: int = 8, seed: int = 555,
                     protocols=EVAL_PROTOCOLS, dtype=None, image_source=None):
    """Held-out accuracy of trained weights, on the parameters' device (the
    estimator's feature warps launch K1 on the card). Images and fields are
    drawn from `seed`, disjoint from any training pool; 'large' and
    'discont' lie outside the training distribution. Returns, per protocol,
    ``(epe_mean, epe_max, passrate_mean, passrate_min)``: the pass rate is
    the share of pixels whose estimated forward/backward pair passes the
    consistency check (consistencyChecker.cpp:80-134), over the pixels
    where the ground-truth pair does. dtype: the estimator's input dtype
    (None: float32). image_source: callable (rng, h, w) -> (h, w, 3) image,
    :func:`random_texture_image` by default."""
    dev = params["pyr0_a"]["w"].device
    if image_source is None:
        image_source = random_texture_image
    results = {}
    for name in protocols:
        # zlib.crc32, not hash(): str hashes are salted per process
        rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
        epes, passrates = [], []
        for _ in range(n_cases):
            img2 = image_source(rng, size, size)[None]
            gt = _protocol_field(name, rng, size, size)[None].astype(np.float32)
            img1 = _warp_np(img2, gt)
            a = torch.from_numpy(img1).to(dev, dtype or torch.float32)
            b = torch.from_numpy(np.ascontiguousarray(img2)).to(dev, dtype or torch.float32)
            fwd = estimator.apply(params, a, b)[0].float()
            bwd = estimator.apply(params, b, a)[0].float()
            epes.append(epe(fwd.cpu(), gt[0]))
            est_mask = consistency.consistency_mask(fwd, bwd).cpu().numpy()
            gt_bwd = _warp_np(-gt, gt)[0]
            gt_mask = consistency.consistency_mask(torch.from_numpy(gt[0]),
                                                   torch.from_numpy(gt_bwd)).numpy()
            valid = gt_mask > 0
            passrates.append(float((est_mask[valid] > 0).mean()) if valid.any() else 0.0)
        results[name] = (float(np.mean(epes)), float(np.max(epes)),
                         float(np.mean(passrates)), float(np.min(passrates)))
    return results
