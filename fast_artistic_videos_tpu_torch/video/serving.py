"""Multi-stream serving: independent video streams fanned over cards —
counterpart of ``fast_artistic_videos_tpu/video/serving.py``.

``StreamPool`` pins each stream's whole recurrence to one device: the
stylizer's parameters, the streaming flow provider's pyramid cache and the
carried stylized frame live on that stream's card; frames in, stylized
frames out, no traffic between cards.

One host thread drives every card (the JAX package's design). It never
waits on a card in ``process``: each frame goes up from pinned host memory
(``Tensor.pin_memory``, whose caching allocator keeps a block until the
copy that read it has finished) by a non-blocking copy on the current
stream of the stream's card, and the only readback is the flow provider's
band signal of the previous pair, copied without blocking a step earlier
(``flow.provider._LateScalar``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import device as device_mod
from ..flow import family
from ..flow.provider import StreamingFlowProvider
from ..models import stylizer
from ..utils import profiling
from .engine import EngineConfig, StylizerEngine


@profiling.traced("pool.upload")
def _upload(frame, device: torch.device) -> torch.Tensor:
    """A frame (numpy or tensor) on `device`. To a card, from pinned host
    memory by a copy on the card's current stream that the host does not
    wait for."""
    t = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) else frame
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StreamPool:
    """S independent temporal-stylization streams over N devices.

    Streams are assigned round-robin (stream i -> devices[i % N]). Each
    stream is sequential (frame t consumes stylized frame t-1); different
    streams' launches run concurrently on different cards. Engines are
    shared per device (they hold no state between calls apart from the
    fill-noise generator); flow providers are per stream (they cache the
    previous frame's pyramid) and share their card's estimator.

    spec, params: the stylizer (``models.checkpoint.load_model``; params on
    any device, copied to each). flow_params: the flow estimator's
    parameters (``flow.estimator.load_params``; either family,
    ``flow.family``), or None when the caller
    passes flow and certainty to :meth:`process`. devices: see
    :func:`core.device.resolve_all` (default: every card; a CUDA
    device raises without one)."""

    def __init__(self, spec, params, flow_params=None, n_streams: int = 1,
                 devices: Optional[Sequence] = None, dtype: str = "bfloat16",
                 flow_scale: float = 1.0, config: Optional[EngineConfig] = None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.devices = device_mod.resolve_all(devices)
        self.n_streams = n_streams
        self._stream_dev = [self.devices[i % len(self.devices)] for i in range(n_streams)]
        cfg = config or EngineConfig(dtype=dtype)
        used = list(dict.fromkeys(self._stream_dev))

        self._engines = {
            dev: StylizerEngine(lambda p, x: stylizer.apply(p, spec, x),
                                params_vid=stylizer.to_device(params, dev),
                                stride_multiple=spec.total_stride, config=cfg, device=dev)
            for dev in used}

        self._providers: List[Optional[StreamingFlowProvider]] = [None] * n_streams
        if flow_params is not None:
            # one estimator per device, one stateful provider per stream
            est = {dev: family.make_estimator(
                       stylizer.to_device(flow_params, dev),
                       dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
                       device=dev)
                   for dev in used}
            self._providers = [StreamingFlowProvider(flow_estimator=est[self._stream_dev[i]],
                                                     flow_scale=flow_scale)
                               for i in range(n_streams)]
        self._prev: List[Optional[torch.Tensor]] = [None] * n_streams
        self._frames = [0] * n_streams      # frames since reset: the spans' key

    def device_of(self, stream: int) -> torch.device:
        return self._stream_dev[stream]

    def reset(self, stream: int) -> None:
        """Start a new clip on this stream slot."""
        self._prev[stream] = None
        self._frames[stream] = 0
        if self._providers[stream] is not None:
            self._providers[stream].reset()

    def process(self, stream: int, frame, flow_cert=None, band_hint=None) -> torch.Tensor:
        """Feed the next frame of `stream` ((H, W, 3) uint8 or [0, 1] float,
        numpy or tensor); returns the stylized frame, (H, W, 3) float32 in
        [0, 1], as a tensor on the stream's device.

        flow_cert: optional (backward_flow, certainty) when flow comes from
        files; omit it to use the pool's streaming flow provider
        (flow_params at construction). The first frame of a stream (or
        after reset) is stylized on its own, as the drivers do. The call is
        the span ``pool.process``, keyed (stream, frames since reset)."""
        frame_no = self._frames[stream]
        self._frames[stream] = frame_no + 1
        with profiling.keyed(stream, frame_no), profiling.span("pool.process"):
            return self._process(stream, frame, flow_cert, band_hint)

    def _process(self, stream: int, frame, flow_cert, band_hint) -> torch.Tensor:
        dev = self._stream_dev[stream]
        eng = self._engines[dev]
        frame_dev = _upload(frame, dev)
        provider = self._providers[stream]
        given = flow_cert is not None
        if flow_cert is None and provider is not None:
            fc = provider(frame_dev)
            if fc is not None:
                flow_cert = fc
                band_hint = provider.last_band
        prev = self._prev[stream]
        if flow_cert is None or prev is None:
            out = eng.stylize_first(frame_dev)
        else:
            flow, cert = flow_cert
            if given:       # the provider's are on the card already
                flow, cert = _upload(flow, dev), _upload(cert, dev)
            out = eng.stylize_next(frame_dev, prev, flow, cert, band_hint)
        self._prev[stream] = out
        return out
