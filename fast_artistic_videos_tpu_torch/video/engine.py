"""The prior-conditioned stylization engine — counterpart of
``fast_artistic_videos_tpu/video/engine.py`` (``stylize_first``,
``stylize_next``, ``stylize_batch``, the feature-reuse steps
``stylize_next_full`` / ``stylize_next_reuse`` and the VR driver's
``stylize_with_prior``).

Per frame: certainty erosion, flow warp of the previous stylized frame
(kernel K1 on CUDA for the banded warp), masking, occlusion fill, the
7-channel VGG-space input, the stylizer forward and de-processing, all on
the engine's device. The recurrence carry (the previous stylized frame)
stays a device tensor between calls.

Frames are (H, W, 3) RGB, float32 in [0, 1] or uint8; flow is (H, W, 2)
(dx, dy) mapping frame-i pixels to frame-(i-1) positions (backward flow);
certainty is (H, W) in [0, 1]. numpy arrays or tensors are accepted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import device as device_mod
from ..ops import filters, warp
from ..ops.preprocess import vgg_deprocess, vgg_preprocess
from ..utils import profiling


@dataclasses.dataclass
class EngineConfig:
    fill_occlusions: str = "vgg-mean"      # 'vgg-mean' | 'uniform-random'
    occlusions_min_filter: int = 7
    dtype: str = "float32"                 # 'float32' | 'bfloat16'
    seed: int = 0                          # seeds the uniform-random fill
    exact_warp: bool = False               # True: exact gather warp;
                                           # False: banded warp (K1 on CUDA)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _unit_f32(x):
    """[0, 1] float32 from float or uint8 input."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def quantize_u8(y):
    """[0, 1] float -> uint8, rounded and clipped."""
    return torch.clamp(torch.round(y * 255.0), 0.0, 255.0).to(torch.uint8)


def _pad_edge(arr, hp: int, wp: int):
    """Edge replication of (H, W, ...) at the bottom and right to (hp, wp)."""
    h, w = arr.shape[0], arr.shape[1]
    if (hp, wp) == (h, w):
        return arr
    rows = torch.arange(hp, device=arr.device).clamp(max=h - 1)
    cols = torch.arange(wp, device=arr.device).clamp(max=w - 1)
    return arr[rows][:, cols]


class StylizerEngine:
    """Stylizes frames with one (image model, video model) pair.

    apply_img may be None: the video model then stylizes independent frames
    with a zero prior and zero certainty (``-model_img self``).

    apply_vid_split + reuse_plan enable the feature-reuse mode: keyframes
    run the full net and keep the residual chain's delta (its output minus
    its cropped input); the frames in between advect that delta by the
    feature-grid flow and recompute only the front and the tail
    (``stylize_next_full`` / ``stylize_next_reuse``).
    apply_vid_split(params, x, *, stop_after=None, start_at=0) is the
    segment-capable form of apply_vid (``models.stylizer.apply``);
    reuse_plan = (front_tap, resume_at, crop) from
    ``models.stylizer.reuse_split_plan(spec)``."""

    def __init__(self, apply_vid: Callable, params_vid, apply_img: Optional[Callable] = None,
                 params_img=None, stride_multiple: int = 4,
                 config: EngineConfig = EngineConfig(), device=device_mod.DEFAULT,
                 apply_vid_split: Optional[Callable] = None,
                 reuse_plan: Optional[Tuple[int, int, int]] = None):
        self.apply_vid = apply_vid
        self.params_vid = params_vid
        self.apply_img = apply_img
        self.params_img = params_img
        self.stride_multiple = max(1, stride_multiple)
        self.config = config
        self.apply_vid_split = apply_vid_split
        self.reuse_plan = reuse_plan
        self.device = device_mod.resolve(device)
        self._dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        self._gen = None
        if config.fill_occlusions == "uniform-random":
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(config.seed)

    @property
    def supports_feature_reuse(self) -> bool:
        return self.apply_vid_split is not None and self.reuse_plan is not None

    # -- device-side steps -------------------------------------------------

    def _fill(self, cert3, shape):
        """Occlusion fill in VGG space: zeros for 'vgg-mean', preprocessed
        uniform noise masked to the occlusions for 'uniform-random'."""
        if self._gen is not None:
            rnd = torch.rand(shape, generator=self._gen, device=self.device)
            return vgg_preprocess(rnd) * (1.0 - cert3)
        return torch.zeros(shape, device=self.device)

    def _run_model(self, which, x):
        x = x.to(self._dtype)
        with profiling.span("stylizer"):
            if which == "img":
                return self.apply_img(self.params_img, x)
            return self.apply_vid(self.params_vid, x)

    def _first(self, contents):
        """contents (N, H, W, 3) -> stylized (N, H, W, 3) float32 [0, 1]."""
        c = vgg_preprocess(_unit_f32(contents))
        if self.apply_img is not None:
            y = self._run_model("img", c)
        else:
            n, h, w = contents.shape[:3]
            cert3 = torch.zeros((n, h, w, 3), device=self.device)
            fill = self._fill(cert3, (n, h, w, 3))
            zeros = torch.zeros((n, h, w, 1), device=self.device)
            y = self._run_model("vid", torch.cat([c, fill, zeros], dim=-1))
        return torch.clamp(vgg_deprocess(y), 0.0, 1.0).float()

    def _assemble(self, content, prior_rgb, cert):
        """The 7-channel stylizer input (content, masked and filled prior,
        certainty), in VGG space."""
        h, w = content.shape[:2]
        cert1 = cert[None, :, :, None]
        cert3 = cert1.expand(1, h, w, 3)
        c = vgg_preprocess(_unit_f32(content))[None]
        prior = vgg_preprocess(prior_rgb.float())[None] * cert3
        prior = prior + self._fill(cert3, (1, h, w, 3))
        return torch.cat([c, prior, cert1], dim=-1)

    def _stylize_with_prior(self, content, prior_rgb, cert, erode: bool = False):
        if erode:
            cert = filters.min_filter(cert, self.config.occlusions_min_filter)
        y = self._run_model("vid", self._assemble(content, prior_rgb, cert))
        return torch.clamp(vgg_deprocess(y[0]), 0.0, 1.0).float()

    def _next(self, content, prev_stylized, flow, cert, band, pre_eroded):
        if not pre_eroded:
            cert = filters.min_filter(cert, self.config.occlusions_min_filter)
        prior_rgb = warp.bilinear_warp(prev_stylized, flow, band=band)
        return self._stylize_with_prior(content, prior_rgb, cert)

    # -- feature-reuse mode (keyframe + delta advection) ---------------------

    def _split(self, x, **kw):
        return self.apply_vid_split(self.params_vid, x, **kw)

    def _front(self, content, prev_stylized, flow, cert, band):
        """The eroded certainty and the front features up to the reuse tap,
        cropped to the residual chain's output grid: (cert, f, fc)."""
        cert = filters.min_filter(cert, self.config.occlusions_min_filter)
        prior_rgb = warp.bilinear_warp(prev_stylized, flow, band=band)
        x = self._assemble(content, prior_rgb, cert)
        tap, _, crop = self.reuse_plan
        f = self._split(x.to(self._dtype), stop_after=tap)
        fc = f[:, crop:f.shape[1] - crop, crop:f.shape[2] - crop] if crop else f
        return cert, f, fc

    def _next_full(self, content, prev_stylized, flow, cert, band):
        """Keyframe: the exact step, split at the residual chain to also
        return delta = f_blocks - crop(f_front), float32 (hq, wq, C)."""
        tap, resume, _ = self.reuse_plan
        _, f, fc = self._front(content, prev_stylized, flow, cert, band)
        fb = self._split(f, start_at=tap + 1, stop_after=resume - 1)
        y = self._split(fb, start_at=resume)
        out = torch.clamp(vgg_deprocess(y[0]), 0.0, 1.0).float()
        return out, (fb.float() - fc.float())[0]

    def _next_reuse(self, content, prev_stylized, flow, cert, delta, band, qband):
        """Reuse step: front and tail recomputed for this frame; the residual
        chain replaced by `delta` warped by the feature-grid flow (kernel K1
        on CUDA for a banded warp) and masked by the eroded certainty, so
        occluded regions fall back to this frame's own front features."""
        _, resume, _ = self.reuse_plan
        cert, _, fc = self._front(content, prev_stylized, flow, cert, band)
        hq, wq = fc.shape[1], fc.shape[2]
        r = content.shape[0] // hq                    # feature-grid downsample
        fq = flow.reshape(hq, r, wq, r, 2).mean(dim=(1, 3)) / r
        cq = cert.reshape(hq, r, wq, r).amin(dim=(1, 3))
        dw = warp.bilinear_warp(delta, fq, band=qband) * cq[..., None]
        y = self._split(fc + dw[None].to(fc.dtype), start_at=resume)
        out = torch.clamp(vgg_deprocess(y[0]), 0.0, 1.0).float()
        return out, dw

    # -- host API ------------------------------------------------------------

    def _tensor(self, arr):
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        return arr.to(self.device)

    def _pad(self, arr, mode="edge"):
        """Stride padding at the bottom and right: edge replication, or
        zeros for mode='constant'."""
        arr = self._tensor(arr)
        h, w = arr.shape[0], arr.shape[1]
        hp, wp = _round_up(h, self.stride_multiple), _round_up(w, self.stride_multiple)
        if (hp, wp) == (h, w):
            return arr, (h, w)
        if mode == "edge":
            return _pad_edge(arr, hp, wp), (h, w)
        out = arr.new_zeros((hp, wp) + tuple(arr.shape[2:]))
        out[:h, :w] = arr
        return out, (h, w)

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_first(self, content, emit_u8=False):
        """Stylize one frame independently. Returns the (H, W, 3) float32
        device tensor, and with emit_u8 also its uint8 quantization."""
        content, (h, w) = self._pad(content)
        out = self._first(content[None])[0, :h, :w]
        if emit_u8:
            return out, quantize_u8(out)
        return out

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_batch(self, contents) -> List[torch.Tensor]:
        """Stylize N independent frames in one forward (no temporal prior):
        the create_inconsistent throughput mode. Frames may differ in size:
        the batch is edge-padded to the largest stride-rounded frame and
        each output is cropped to its own input's (h, w)."""
        frames = [self._tensor(c) for c in contents]
        shapes = [(f.shape[0], f.shape[1]) for f in frames]
        hm = _round_up(max(h for h, _ in shapes), self.stride_multiple)
        wm = _round_up(max(w for _, w in shapes), self.stride_multiple)
        out = self._first(torch.stack([_pad_edge(f, hm, wm) for f in frames]))
        return [out[i, :h, :w] for i, (h, w) in enumerate(shapes)]

    def _band(self, flow, band_hint):
        if self.config.exact_warp:
            return None
        if band_hint is not None:
            return band_hint
        if isinstance(flow, np.ndarray):
            return warp.flow_band(float(np.abs(flow).max()))
        return warp.flow_band(float(flow.abs().max()))

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_next(self, content, prev_stylized, flow, cert, band_hint=None,
                     emit_u8=False, pre_eroded=False):
        """One recurrent step. prev_stylized is usually the tensor a previous
        stylize_* call returned. band_hint: a warp band known to cover
        |flow| (the streaming provider's), which saves the flow-range
        readback. pre_eroded: the certainty is already eroded (the provider
        erodes it at flow resolution), so the min-filter is skipped."""
        args, band, (h, w) = self._prep_next(content, prev_stylized, flow, cert,
                                             band_hint)
        out = self._next(*args, band, pre_eroded)[:h, :w]
        if emit_u8:
            return out, quantize_u8(out)
        return out

    def _prep_next(self, content, prev_stylized, flow, cert, band_hint):
        """The step's inputs padded to the stride multiple on the device,
        its warp band and the unpadded (h, w)."""
        band = self._band(flow, band_hint)
        content, (h, w) = self._pad(content)
        prev_stylized, _ = self._pad(prev_stylized)
        flow, _ = self._pad(flow)
        cert, _ = self._pad(cert, mode="constant")   # padded area = occluded
        return (content, prev_stylized, flow.float(), cert.float()), band, (h, w)

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_next_full(self, content, prev_stylized, flow, cert, band_hint=None):
        """Feature-reuse keyframe: stylize_next's math, plus the residual
        chain's delta (a device tensor) for stylize_next_reuse."""
        args, band, (h, w) = self._prep_next(content, prev_stylized, flow, cert,
                                             band_hint)
        out, delta = self._next_full(*args, band)
        return out[:h, :w], delta

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_next_reuse(self, content, prev_stylized, flow, cert, delta,
                           band_hint=None):
        """Feature-reuse in-between frame: the front and the tail for this
        frame, the residual chain replaced by `delta` (from the last
        keyframe or reuse step) advected by the feature-grid flow. Returns
        (frame, advected delta); pass the delta to the next reuse step."""
        args, band, (h, w) = self._prep_next(content, prev_stylized, flow, cert,
                                             band_hint)
        qband = None
        if band is not None:
            qband = warp.flow_band(band / self.stride_multiple)
        out, delta = self._next_reuse(*args, delta, band, qband)
        return out[:h, :w], delta

    @profiling.traced("engine.step")
    @torch.no_grad()
    def stylize_with_prior(self, content, prior_rgb, cert, erode_cert: bool = True):
        """VR-style entry: the caller assembles the prior image (the cube
        faces' border priors); the certainty is eroded here unless
        erode_cert is False. Pads to the stride multiple, unpads the
        result."""
        content, (h, w) = self._pad(content)
        prior_rgb, _ = self._pad(prior_rgb)
        cert, _ = self._pad(cert, mode="constant")   # padded area = occluded
        out = self._stylize_with_prior(content, prior_rgb.float(), cert.float(),
                                       erode=erode_cert)
        return out[:h, :w]
