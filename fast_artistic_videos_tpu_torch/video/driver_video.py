"""2D video stylization driver — counterpart of
``fast_artistic_videos_tpu/video/driver_video.py`` (``VideoDriver.run``).

Frame recurrence: frame 1 (or every frame with create_inconsistent) is
stylized independently; frame i warps the stylized frame i-1 by the
backward flow and conditions on it through the certainty mask. Flow and
certainty come from a streaming provider or from files named by the flow
pattern DSL. A prefetch thread loads and uploads frame i+1 (and runs the
flow provider on it) while the device stylizes frame i; a writer thread
saves the uint8 frames that come out of the same step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import io
from ..core.config import StylizeOptions, format_flow_name
from ..ops import warp
from ..utils import pipeline
from .engine import StylizerEngine

NOT_PORTED = "not carried by the PyTorch port yet (see ROADMAP.md)"


def check_supported(opt: StylizeOptions) -> None:
    """Raise for the options this port does not carry yet."""
    if opt.phase_resident:
        raise NotImplementedError(f"--phase_resident is {NOT_PORTED}")
    if opt.feature_reuse > 1:
        raise NotImplementedError(f"--feature_reuse > 1 is {NOT_PORTED}")
    if opt.evaluate:
        raise NotImplementedError(f"--evaluate is {NOT_PORTED}")
    if opt.create_inconsistent and opt.inconsistent_batch > 1:
        raise NotImplementedError(
            f"--create_inconsistent with --inconsistent_batch > 1 is {NOT_PORTED}")
    if opt.scale_factor != 1.0:
        raise NotImplementedError(f"--scale_factor != 1 is {NOT_PORTED}")


def fix_occlusions_mask(cert: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Zero certainty where warping leaves no correspondence: warp an
    all-ones image and threshold at 0.5 (fast_artistic_video.lua:79-86)."""
    ones = torch.ones(cert.shape + (1,))
    weight = warp.bilinear_warp(ones, torch.from_numpy(flow))[..., 0].numpy()
    return cert * np.sign(weight - 0.5).clip(min=0.0)


@dataclasses.dataclass
class FrameResult:
    index: int
    path: str
    seconds: float


class VideoDriver:
    def __init__(self, engine: StylizerEngine, opt: StylizeOptions,
                 flow_provider: Optional[Callable] = None):
        """flow_provider: a streaming estimator (flow.provider
        .StreamingFlowProvider) replacing the flow files; it sees every
        frame in order. On a continue_with resume it is primed with the last
        input frame, so the resumed frame warps the reloaded output."""
        check_supported(opt)
        self.engine = engine
        self.opt = opt
        self.flow_provider = flow_provider

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
            cert = fix_occlusions_mask(cert, flow)
        return flow, cert

    def _load_inputs(self, i: int):
        """Prefetchable bundle for frame i: (frame, flow_cert)."""
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
        results: List[FrameResult] = []
        last_stylized = None      # the recurrence carry, a device tensor
        if opt.continue_with > 1 and not opt.backward:
            prev_path = self._out_path(opt.continue_with - 1)
            if os.path.exists(prev_path):
                last_stylized = torch.from_numpy(io.load_image(prev_path)).to(
                    self.engine.device)
                if self.flow_provider is not None:
                    # prime the provider with the last INPUT frame so the
                    # resumed frame gets a real flow/cert pair
                    prev_in = self.load_frame_device(opt.continue_with - 1)
                    if prev_in is not None:
                        self.flow_provider(prev_in)
                    else:
                        last_stylized = None   # no input frame: cold start
        pre_eroded = bool(getattr(self.flow_provider, "erode_window", None))
        writer = pipeline.AsyncWriter()
        try:
            for i, (frame, flow_cert) in pipeline.Prefetcher(self._load_inputs, indices):
                t0 = time.monotonic()
                if flow_cert is None or last_stylized is None:
                    stylized, out_u8 = self.engine.stylize_first(frame, emit_u8=True)
                else:
                    flow, cert, *rest = flow_cert
                    band_hint = rest[0] if rest else None
                    stylized, out_u8 = self.engine.stylize_next(
                        frame, last_stylized, flow, cert, band_hint,
                        emit_u8=True, pre_eroded=pre_eroded)
                dt = time.monotonic() - t0
                out_path = self._out_path(i)
                # the writer thread downloads the uint8 frame (its copy
                # waits for this step's device work, not this thread)
                writer.put(lambda p=out_path, s=out_u8: self.save(p, s.cpu().numpy()))
                if progress:
                    print(f"frame {i}: {dt * 1000:.1f} ms -> {out_path}")
                last_stylized = stylized
                results.append(FrameResult(i, out_path, dt))
        finally:
            writer.close()
        return results
