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

On a card the step is replayed from CUDA graphs (``flow.graphs``), which
providers on one estimator share: a few launches a step instead of
thousands. The first frame and the first pair of a key run eagerly, and
so does every step of an estimator that is not ``capturable`` (FlowNet
2.0's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import device as device_mod
from ..ops.warp import flow_band
from ..utils import profiling
from . import consistency, family
from . import graphs as step_graphs


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


class _Streaming:
    """What both providers share: the estimator, what a stream carries from
    step to step (the previous frame's features, the late band signal) and
    the step itself, eager or replayed from CUDA graphs.

    A step is the new frame's features (``_prep``) and both flows of the
    pair against the previous frame's (``_refine``: part "pair"), the band
    read, and the consistency check at that band (``_check``: part
    ("check", band)). On a card the step replays those parts as graphs
    shared by every provider on the estimator (``flow.graphs``); a key's
    first frame and first pair run eagerly, which also warms cuDNN up
    before any capture, and once its graphs exist a stream's first frame
    (part "prep") and first pair replay too. On the CPU, and with an
    estimator that is not ``capturable``, every step is eager."""

    def _setup(self, params, device, flow_estimator, dtype, flow_scale: float,
               fast_check: bool) -> None:
        if flow_estimator is not None:
            self.estimator = flow_estimator
        else:
            if params is None:
                raise ValueError("need params or flow_estimator")
            self.estimator = family.make_estimator(
                params, dtype=dtype or torch.float32, device=device)
        self.flow_scale = flow_scale
        self.fast_check = fast_check
        self._prev_feats = None
        self._pending: Optional[_LateScalar] = None
        self.last_band = None
        # the graphs of the key of the last step: held, so that the
        # estimator's table keeps them while this provider may step again
        self._held = None

    def reset(self) -> None:
        self._prev_feats = None
        self._pending = None

    def _engine_band(self, warp_low: int) -> int:
        """The engine's warp band, at full resolution, for the bucket
        `warp_low` at flow resolution."""
        return flow_band(warp_low / self.flow_scale) if self.flow_scale != 1.0 else warp_low

    def _band(self, flows) -> int:
        """The band bucket at flow resolution; sets ``last_band``."""
        # the band comes from the PREVIOUS pair's signal, whose copy has
        # finished; only the first pair reads its own maximum
        prev = self._pending.get() if self._pending is not None else float(flows[-1])
        warp_low = flow_band(prev)
        self.last_band = self._engine_band(warp_low)
        return warp_low

    def _pair(self, frames, prev_feats):
        feats = self._prep(frames)
        return feats, self._refine(frames, feats, prev_feats)

    @torch.no_grad()
    def _step(self, frames):
        graphs = self._held = self._graphs(frames)
        if graphs is None or (self._pending is None and not graphs.has("pair")):
            return self._eager(frames)
        with graphs.use():
            return self._replayed(graphs, frames)

    def _graphs(self, frames):
        dev = self.estimator.device
        if dev.type != "cuda" or not self.estimator.capturable:
            return None
        card = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                            else dev.index)
        key = (type(self).__name__, card, tuple(frames.shape), frames.dtype,
               self.flow_scale) + self._settings()
        return step_graphs.shared(self.estimator, key, card)

    def _eager(self, frames):
        feats = self._prep(frames)
        prev_feats, self._prev_feats = self._prev_feats, feats
        if prev_feats is None:
            return None
        flows = self._refine(frames, feats, prev_feats)
        cert, rel_max = self._check(frames, flows, self._band(flows))
        self._pending = _LateScalar(rel_max)
        return self._result(flows[0], cert)

    def _replayed(self, graphs, frames):
        """The step from the graphs of its key; what it returns and keeps
        is copied out of their static outputs."""
        first = self._prev_feats is None
        graphs.load(frames, None if first else self._prev_feats)
        if first:
            self._prev_feats = step_graphs.clone(
                graphs.run("prep", lambda: self._prep(graphs.frames)))
            return None
        feats, flows = graphs.run("pair", lambda: self._pair(graphs.frames, graphs.prev))
        self._prev_feats = step_graphs.clone(feats)
        backward = flows[0].clone()
        warp_low = self._band(flows)
        cert, rel_max = graphs.run(("check", warp_low),
                                   lambda: self._check(graphs.frames, flows, warp_low))
        self._pending = _LateScalar(rel_max)
        return self._result(backward, cert.clone())


class StreamingFlowProvider(_Streaming):
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
        self._setup(params, device, flow_estimator, dtype, flow_scale, fast_check)
        self.coarse_backward = coarse_backward
        self.erode_window = erode_window
        if erode_window and flow_scale >= 1.0:
            raise ValueError("erode_window needs flow_scale < 1.0")

    @profiling.traced("flow")
    def __call__(self, frame) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        return self._step(frame)

    def _settings(self):
        return self.coarse_backward, self.fast_check, self.erode_window

    def _prep(self, frame):
        return self.estimator.prep(frame, self.flow_scale)

    def _refine(self, frame, feats, prev_feats):
        """(backward, backward_low, forward_low, maxabs) at a reduced flow
        scale, else (backward, forward, maxabs)."""
        return self.estimator.refine_pair(
            feats, prev_feats, tuple(frame.shape[:2]), self.flow_scale,
            with_lowres=self.flow_scale != 1.0, coarse_backward=self.coarse_backward,
            fast_check=self.fast_check)

    def _check(self, frame, flows, warp_low: int):
        hw = tuple(frame.shape[:2])
        # the check composes a round trip, so its banded sample needs twice
        # the engine warp's coverage
        band = 2 * warp_low
        image = frame.to(flows[0].device)
        if self.flow_scale != 1.0:
            _, bwd_low, fwd_low, _ = flows
            limit_low = self._engine_band(warp_low) * bwd_low.shape[0] / hw[0]
            return consistency.consistency_mask_streaming(
                bwd_low, fwd_low, image, out_hw=hw, band=band,
                erode_window=self.erode_window, warp_limit=limit_low,
                with_rel_maxabs=True)
        backward, forward, _ = flows
        if image.dtype == torch.uint8:
            image = image.float() / 255.0
        return consistency.consistency_mask(
            backward, forward, image, band=band, warp_limit=float(warp_low),
            with_rel_maxabs=True)

    def _result(self, backward, cert):
        return backward, cert


class BatchedStreamingFlowProvider(_Streaming):
    """Streaming flow for N synchronized temporal streams (the VR driver's
    six cube faces, each its own stream, all advancing together): per step
    one batched pyramid, one batched refine of both directions and the
    flow-resolution consistency check of every pair.

    Call it with frames (N, H, W, 3) (uint8 or [0, 1], on the estimator's
    device); it returns a list of N (backward_flow, certainty) device-tensor
    pairs, or None for the first step. The band bucket is shared by the
    streams and sized from the previous step's maximum |flow| over the
    check-passing pixels of the whole batch, read back without blocking."""

    def __init__(self, params=None, device=device_mod.DEFAULT, flow_scale: float = 1.0,
                 flow_estimator=None, dtype=None, fast_check: bool = False):
        self._setup(params, device, flow_estimator, dtype, flow_scale, fast_check)

    @profiling.traced("flow")
    def __call__(self, frames):
        return self._step(frames)

    def _settings(self):
        return (self.fast_check,)

    def _prep(self, frames):
        return self.estimator.prep_batch(frames, self.flow_scale)

    def _refine(self, frames, feats, prev_feats):
        """(backward, backward_low, forward_low, maxabs over the batch)."""
        return self.estimator.refine_pair_batch(
            feats, prev_feats, tuple(frames.shape[1:3]), self.flow_scale,
            fast_check=self.fast_check)

    def _check(self, frames, flows, warp_low: int):
        # engine band = the plain bucket, consistency band = twice that (the
        # check composes a round trip); out-of-band pixels are masked
        h, w = frames.shape[1], frames.shape[2]
        _, bwd_low, fwd_low, _ = flows
        limit_low = self._engine_band(warp_low) * bwd_low.shape[1] / h
        return consistency.consistency_mask_streaming_batch(
            bwd_low, fwd_low, frames.to(flows[0].device), out_hw=(h, w), band=2 * warp_low,
            warp_limit=limit_low, with_rel_maxabs=True)

    def _result(self, backward, certs):
        return [(backward[i], certs[i]) for i in range(backward.shape[0])]
