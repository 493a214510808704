"""Streaming flow providers — counterpart of
``fast_artistic_videos_tpu/flow/provider.py`` (``StreamingFlowProvider``,
and ``BatchedStreamingFlowProvider`` for the VR driver's six faces).

For each consecutive frame pair: backward flow (frame i -> i-1), the
cross-check direction and the consistency mask, all on the device. Each
frame's feature pyramid is computed once and reused for the next pair. The
only host traffic per step is the frame upload and one scalar read back a
step late: the band-sizing signal (max |flow| over check-passing pixels)
is copied into pinned memory without blocking and read when the next pair
needs it, by which time the copy has long finished.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import device as device_mod
from ..ops.warp import flow_band
from ..utils import profiling
from . import consistency, family


class _LateScalar:
    """A 0-d device tensor copied to the host without blocking; ``get``
    waits for that copy alone (an event), not for the device. The copy
    runs on the current stream of `t`'s card, whichever card is current,
    so the event is recorded on that stream."""

    def __init__(self, t):
        if t.is_cuda:
            self._host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    @profiling.traced("flow.band_wait")
    def get(self) -> float:
        if self._event is not None:
            self._event.synchronize()
        return float(self._host)


class StreamingFlowProvider:
    """Stateful: remembers the previous frame's pyramid; feed it frames in
    playback order. Call it with frame i ((H, W, 3) uint8 or [0, 1] tensor
    on the estimator's device); it returns (backward_flow_i, certainty_i)
    device tensors against the previous frame, or None for the first.
    ``last_band`` is then the engine warp band covering that flow."""

    def __init__(self, params=None, device=device_mod.DEFAULT, flow_scale: float = 1.0,
                 flow_estimator=None, dtype=None, coarse_backward: bool = False,
                 fast_check: bool = False, erode_window=None):
        """flow_scale < 1 estimates flow at reduced resolution and runs the
        consistency check there, nearest-upsampling the mask. erode_window
        applies the engine's occlusion min-filter inside the check, exactly,
        at flow resolution (the engine is then called with
        pre_eroded=True). dtype: the estimator's feature dtype (flow
        accumulates in float32). flow_estimator: share one estimator
        between providers instead of building one from params on `device`
        (the card unless ``device="cpu"``)."""
        if flow_estimator is not None:
            self.estimator = flow_estimator
        else:
            if params is None:
                raise ValueError("need params or flow_estimator")
            self.estimator = family.make_estimator(
                params, dtype=dtype or torch.float32, device=device)
        self.flow_scale = flow_scale
        self.coarse_backward = coarse_backward
        self.fast_check = fast_check
        self.erode_window = erode_window
        if erode_window and flow_scale >= 1.0:
            raise ValueError("erode_window needs flow_scale < 1.0")
        self._prev_feats = None
        self._pending: Optional[_LateScalar] = None
        self.last_band = None

    def reset(self) -> None:
        self._prev_feats = None
        self._pending = None

    @profiling.traced("flow")
    @torch.no_grad()
    def __call__(self, frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        feats = self.estimator.prep(frame, self.flow_scale)
        prev_feats, self._prev_feats = self._prev_feats, feats
        if prev_feats is None:
            return None
        hw = tuple(frame.shape[:2])
        lowres = self.flow_scale != 1.0
        if lowres:
            backward, bwd_low, fwd_low, maxabs = self.estimator.refine_pair(
                feats, prev_feats, hw, self.flow_scale, with_lowres=True,
                coarse_backward=self.coarse_backward, fast_check=self.fast_check)
        else:
            backward, forward, maxabs = self.estimator.refine_pair(
                feats, prev_feats, hw, self.flow_scale,
                coarse_backward=self.coarse_backward, fast_check=self.fast_check)
        # the band comes from the PREVIOUS pair's signal, whose copy has
        # finished; only the first pair reads its own maximum
        prev = self._pending.get() if self._pending is not None else float(maxabs)
        warp_low = flow_band(prev)
        # the check composes a round trip, so its banded sample needs twice
        # the engine warp's coverage
        band = 2 * warp_low
        image = frame.to(backward.device)
        if lowres:
            self.last_band = flow_band(warp_low / self.flow_scale)
            limit_low = self.last_band * bwd_low.shape[0] / hw[0]
            cert, rel_max = consistency.consistency_mask_streaming(
                bwd_low, fwd_low, image, out_hw=hw, band=band,
                erode_window=self.erode_window, warp_limit=limit_low,
                with_rel_maxabs=True)
        else:
            self.last_band = warp_low
            if image.dtype == torch.uint8:
                image = image.float() / 255.0
            cert, rel_max = consistency.consistency_mask(
                backward, forward, image, band=band, warp_limit=float(warp_low),
                with_rel_maxabs=True)
        self._pending = _LateScalar(rel_max)
        return backward, cert


class BatchedStreamingFlowProvider:
    """Streaming flow for N synchronized temporal streams (the VR driver's
    six cube faces, each its own stream, all advancing together): per step
    one batched pyramid, one batched refine of both directions and the
    flow-resolution consistency check of every pair.

    Call it with frames (N, H, W, 3) (uint8 or [0, 1], on the estimator's
    device); it returns a list of N (backward_flow, certainty) device-tensor
    pairs, or None for the first step. The band bucket is shared by the
    streams and sized from the previous step's maximum |flow| over the
    check-passing pixels of the whole batch, read back without blocking."""

    def __init__(self, params=None, device=device_mod.DEFAULT, use_structure: bool = True,
                 flow_scale: float = 1.0, flow_estimator=None, dtype=None,
                 fast_check: bool = False):
        if flow_estimator is not None:
            self.estimator = flow_estimator
        else:
            if params is None:
                raise ValueError("need params or flow_estimator")
            self.estimator = family.make_estimator(
                params, dtype=dtype or torch.float32, device=device)
        self.use_structure = use_structure
        self.flow_scale = flow_scale
        self.fast_check = fast_check
        self._prev_feats = None
        self._pending: Optional[_LateScalar] = None
        self.last_band = None

    def reset(self) -> None:
        self._prev_feats = None
        self._pending = None

    @profiling.traced("flow")
    @torch.no_grad()
    def __call__(self, frames):
        n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        feats = self.estimator.prep_batch(frames, self.flow_scale)
        prev_feats, self._prev_feats = self._prev_feats, feats
        if prev_feats is None:
            return None
        backward, bwd_low, fwd_low, maxabs = self.estimator.refine_pair_batch(
            feats, prev_feats, (h, w), self.flow_scale, fast_check=self.fast_check)
        # engine band = the plain bucket, consistency band = twice that (the
        # check composes a round trip); out-of-band pixels are masked
        prev = self._pending.get() if self._pending is not None else float(maxabs)
        warp_low = flow_band(prev)
        band = 2 * warp_low
        if self.flow_scale != 1.0:
            self.last_band = flow_band(warp_low / self.flow_scale)
        else:
            self.last_band = warp_low
        limit_low = self.last_band * bwd_low.shape[1] / h
        images = frames.to(backward.device) if self.use_structure else None
        certs, rel_max = consistency.consistency_mask_streaming_batch(
            bwd_low, fwd_low, images, out_hw=(h, w), band=band,
            warp_limit=limit_low, with_rel_maxabs=True)
        self._pending = _LateScalar(rel_max)
        return [(backward[i], certs[i]) for i in range(n)]
