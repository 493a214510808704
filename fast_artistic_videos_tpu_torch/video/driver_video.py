"""2D video stylization driver — counterpart of
``fast_artistic_videos_tpu/video/driver_video.py`` (``VideoDriver.run``).

Frame recurrence: frame 1 (or every frame with create_inconsistent) is
stylized independently; frame i warps the stylized frame i-1 by the
backward flow and conditions on it through the certainty mask. Flow and
certainty come from a streaming provider or from files named by the flow
pattern DSL. A prefetch thread loads and uploads frame i+1 (and runs the
flow provider on it) while the device stylizes frame i; a writer thread
saves the uint8 frames that come out of the same step.

With an ``eval_fn`` (``video.evaluation.VideoEvaluator``, ``--evaluate``)
every frame of the recurrent loop is scored on the device, against the
previous stylized frame kept there as a tensor, and the rows are written
to ``evaluation_file``.

Modes: ``--create_inconsistent --inconsistent_batch N`` stylizes N
independent frames per forward (``_run_batched``); ``--feature_reuse K``
runs a full keyframe every K frames and advects the residual chain's delta
in between; ``--scale_factor s`` stylizes at s times the frame size (the
recurrence is carried at that size) and resizes each output back.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import io
from ..core.config import StylizeOptions, format_flow_name
from ..ops import warp
from ..utils import pipeline, profiling
from .engine import StylizerEngine, quantize_u8
from .evaluation import write_eval_file


def fix_occlusions_mask(cert, flow):
    """Zero certainty where warping leaves no correspondence: the warp of an
    all-ones image, thresholded at 0.5 (fast_artistic_video.lua:79-86).
    cert (H, W) and flow (H, W, 2) tensors, on their device."""
    weight = warp.warp_weight_map(flow, *cert.shape)
    return cert * torch.sign(weight - 0.5).clamp(min=0.0)


def resize_bicubic(arr, scale: float):
    """(H, W, C) tensor -> (round(H s), round(W s), C) float32: the JAX
    package's ``jax.image.resize(method="bicubic")``, i.e. Keys' cubic
    (a = -0.5) widened by 1/s when shrinking, with weights renormalized at
    the borders, which is torch's antialiased bicubic."""
    h, w = arr.shape[0], arr.shape[1]
    return resize_bicubic_to(arr, (int(round(h * scale)), int(round(w * scale))))


def resize_bicubic_to(arr, size):
    """:func:`resize_bicubic` to size (h, w): (H, W, C) or (N, H, W, C)
    tensor -> (..., h, w, C) float32."""
    x = arr.float()
    x = (x[None] if x.ndim == 3 else x).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=False,
                      antialias=True).permute(0, 2, 3, 1)
    return y[0] if arr.ndim == 3 else y


@dataclasses.dataclass
class FrameResult:
    index: int
    path: str
    seconds: float


class VideoDriver:
    def __init__(self, engine: StylizerEngine, opt: StylizeOptions,
                 eval_fn: Optional[Callable] = None,
                 flow_provider: Optional[Callable] = None):
        """eval_fn: called as eval_fn(i, content, stylized, prev_stylized)
        with device tensors (content in [0, 1]; prev_stylized None for the
        first frame scored), returning a row of floats or None.
        flow_provider: a streaming estimator (flow.provider
        .StreamingFlowProvider) replacing the flow files; it sees every
        frame in order. On a continue_with resume it is primed with the last
        input frame, so the resumed frame warps the reloaded output."""
        self.engine = engine
        self.opt = opt
        self.eval_fn = eval_fn
        self.flow_provider = flow_provider
        self.eval_rows: List[List[float]] = []

    # -- input loading ----------------------------------------------------

    def _frame_path(self, i: int) -> str:
        return self.opt.input_pattern % i

    def load_frame_device(self, i: int):
        """Frame i as a uint8 tensor on the engine's device (the one upload
        shared by the flow provider and the engine), or None past the end."""
        path = self._frame_path(i)
        if not os.path.exists(path):
            return None
        return torch.from_numpy(io.load_image_u8(path)).to(self.engine.device)

    def load_flow_cert(self, i: int):
        opt = self.opt
        flow_name = format_flow_name(opt.flow_pattern, i - 1, i)
        cert_name = format_flow_name(opt.occlusions_pattern, i - 1, i)
        pipeline.wait_for_file(cert_name)
        pipeline.wait_for_file(flow_name)
        flow = io.read_flo(flow_name)
        cert = io.load_image(cert_name, num_channels=1)[..., 0]
        if opt.invert_occlusion:
            cert = 1.0 - cert
        if opt.fix_occlusions:
            cert = fix_occlusions_mask(torch.from_numpy(cert), torch.from_numpy(flow)).numpy()
        return flow, cert

    def _load_inputs(self, i: int):
        """Prefetchable bundle for frame i: (frame, flow_cert)."""
        with profiling.keyed(0, i):
            frame = self.load_frame_device(i)
            if frame is None:
                return None
            first = self._is_single_image(i)
            if self.flow_provider is not None and not self.opt.create_inconsistent:
                flow_cert = self.flow_provider(frame)
                if flow_cert is not None:
                    # the band of THIS pair, read before the provider moves on
                    flow_cert = flow_cert + (getattr(self.flow_provider, "last_band", None),)
                if first:
                    flow_cert = None
            else:
                flow_cert = None if first else self.load_flow_cert(i)
            return frame, flow_cert

    def _is_single_image(self, i: int) -> bool:
        if self.opt.create_inconsistent:
            return True
        return i == (self.opt.num_frames if self.opt.backward else 1)

    def _out_path(self, i: int) -> str:
        return f"{self.opt.output_prefix}-{i:05d}.png"

    def save(self, path: str, u8: np.ndarray) -> None:
        io.save_image(path, u8)

    # -- main loop --------------------------------------------------------

    def run(self, progress: bool = True) -> List[FrameResult]:
        opt = self.opt
        if opt.backward:
            indices = list(range(opt.num_frames, 0, -1))
        else:
            indices = list(range(opt.continue_with, opt.num_frames + 1))
        if opt.create_inconsistent and opt.inconsistent_batch > 1:
            return self._run_batched(indices, progress)
        results: List[FrameResult] = []
        scale = opt.scale_factor
        last_stylized = None      # the recurrence carry, a device tensor
        if opt.continue_with > 1 and not opt.backward:
            prev_path = self._out_path(opt.continue_with - 1)
            if os.path.exists(prev_path):
                last_stylized = torch.from_numpy(io.load_image(prev_path)).to(
                    self.engine.device)
                if scale != 1.0:
                    last_stylized = resize_bicubic(last_stylized, scale)
                if self.flow_provider is not None:
                    # prime the provider with the last INPUT frame so the
                    # resumed frame gets a real flow/cert pair
                    prev_in = self.load_frame_device(opt.continue_with - 1)
                    if prev_in is not None:
                        self.flow_provider(prev_in)
                    else:
                        last_stylized = None   # no input frame: cold start
        # feature reuse (--feature_reuse K): a keyframe once K-1 reuse
        # frames have passed since the last full forward
        reuse_k = opt.feature_reuse if self.engine.supports_feature_reuse else 0
        delta = None
        key_age = 0
        # the uint8 frame comes out of the step itself when the output is
        # the stylized frame as it is
        fused_u8 = scale == 1.0 and reuse_k <= 1
        pre_eroded = bool(getattr(self.flow_provider, "erode_window", None))
        if pre_eroded and reuse_k > 1:
            # the reuse steps apply the engine's own min-filter: a provider
            # that already eroded the certainty would erode it twice
            raise ValueError("flow_provider.erode_window and feature_reuse > 1 "
                             "are mutually exclusive")
        prev_out = None           # the previous output, for eval_fn
        writer = pipeline.AsyncWriter()
        try:
            for i, (frame, flow_cert) in pipeline.Prefetcher(self._load_inputs, indices, stream=0):
                with profiling.keyed(0, i):
                    t0 = time.monotonic()
                    content = frame
                    out_u8 = None
                    if scale != 1.0:
                        content = resize_bicubic(frame.float() / 255.0, scale)
                    if flow_cert is None or last_stylized is None:
                        if fused_u8:
                            stylized, out_u8 = self.engine.stylize_first(content, emit_u8=True)
                        else:
                            stylized = self.engine.stylize_first(content)
                        delta = None
                    else:
                        flow, cert, *rest = flow_cert
                        band_hint = rest[0] if rest else None
                        if scale != 1.0:
                            flow = resize_bicubic(self.engine._tensor(flow), scale) * scale
                            cert = resize_bicubic(self.engine._tensor(cert)[..., None],
                                                  scale)[..., 0]
                            if band_hint is not None:
                                band_hint = warp.flow_band(band_hint * scale)
                        if reuse_k > 1:
                            if delta is None or key_age >= reuse_k - 1:
                                stylized, delta = self.engine.stylize_next_full(
                                    content, last_stylized, flow, cert, band_hint)
                                key_age = 0
                            else:
                                stylized, delta = self.engine.stylize_next_reuse(
                                    content, last_stylized, flow, cert, delta, band_hint)
                                key_age += 1
                        elif fused_u8:
                            stylized, out_u8 = self.engine.stylize_next(
                                content, last_stylized, flow, cert, band_hint,
                                emit_u8=True, pre_eroded=pre_eroded)
                        else:
                            stylized = self.engine.stylize_next(
                                content, last_stylized, flow, cert, band_hint,
                                pre_eroded=pre_eroded)
                    out_full = stylized
                    if scale != 1.0:
                        out_full = resize_bicubic(stylized, frame.shape[0] / stylized.shape[0])
                    if out_u8 is None:
                        out_u8 = quantize_u8(out_full)
                    dt = time.monotonic() - t0
                    out_path = self._out_path(i)
                    # the writer thread downloads the uint8 frame (its copy
                    # waits for this step's device work, not this thread)
                    writer.put(lambda p=out_path, s=out_u8: self.save(p, s.cpu().numpy()))
                    if progress:
                        print(f"frame {i}: {dt * 1000:.1f} ms -> {out_path}")
                    if self.eval_fn is not None:
                        row = self.eval_fn(i, frame.float() / 255.0, out_full, prev_out)
                        if row is not None:
                            self.eval_rows.append(list(row))
                        prev_out = out_full
                    last_stylized = stylized
                    results.append(FrameResult(i, out_path, dt))
        finally:
            writer.close()
        if self.eval_rows and opt.evaluation_file:
            write_eval_file(opt.evaluation_file, self.eval_rows)
        return results

    def _run_batched(self, indices, progress: bool) -> List[FrameResult]:
        """create_inconsistent throughput mode: the frames are independent,
        so `inconsistent_batch` of them go through one forward (one launch
        of each block-conv kernel for the whole batch)."""
        results: List[FrameResult] = []
        batch_n = self.opt.inconsistent_batch
        pending: List = []
        writer = pipeline.AsyncWriter()

        def flush():
            if not pending:
                return
            t0 = time.monotonic()
            outs = self.engine.stylize_batch([f for _, f in pending])
            dt = (time.monotonic() - t0) / len(pending)
            for (idx, _), out in zip(pending, outs):
                path = self._out_path(idx)
                writer.put(lambda p=path, s=quantize_u8(out): self.save(p, s.cpu().numpy()))
                if progress:
                    print(f"frame {idx}: {dt * 1000:.1f} ms -> {path}")
                results.append(FrameResult(idx, path, dt))
            pending.clear()

        try:
            for i, (frame, _) in pipeline.Prefetcher(self._load_inputs, indices, stream=0):
                pending.append((i, frame))
                if len(pending) >= batch_n:
                    flush()
            flush()
        finally:
            writer.close()
        return results
