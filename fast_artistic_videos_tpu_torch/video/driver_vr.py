"""Spherical (360°) video driver — counterpart of
``fast_artistic_videos_tpu/video/driver_vr.py`` (fast_artistic_video_vr.lua).

Each equirectangular frame arrives as 6 overlapping cube faces (layout
``2 / 3 6 4 5 / 1``), stylized in the fixed order (6, 1, 2, 5, 3, 4)
(fast_artistic_video_vr.lua:96-103). The engine's prior image carries two
kinds of consistency:

  * spatial: the borders of the faces of the SAME frame already stylized,
    warped into this face's frame by the static border maps and marked
    certain (:204-237, :239-272);
  * temporal: from the second frame on, this face's previous (blended)
    result warped by optical flow, blended with the border prior through
    the gradient masks (:275-295).

After all 6 faces of a frame, the neighbours' borders are blended into
every face (``blend_other_sides``, :454-509) and the frame is written as
face PNGs plus optional median-filtered equirectangular and cubemap images
(:511-559).

The border maps are static, so each gets a strip warp from a factory built
once per face size: kernel K5 (``ops.strip_warp_kernel``) on a CUDA tensor,
its plain version on a CPU tensor, and the exact strip gather
(``ops.warp.make_static_warp``) where a map is not separable or
``pallas_strip_warp`` is False. With all four maps on K5, each border prior
and each frame's cross-face blend is one launch of K5's summing entry
(``strip_warp_kernel.StripSet``); otherwise the same sums are composed
from the four warps (``strip_warp_kernel.BorderSums``). The temporal warp is the banded warp (K1 on
a card) with the flow provider's band. Every face step is the same plain
function (``_face_step``) for streamed and file-pattern flow; all tensors
of a frame stay on the engine's device, and only the uint8 outputs come
back, on the writer thread.

With an ``eval_fn`` (``video.evaluation.VREvaluator``, ``--evaluate``) each
face is scored on the device after it is stylized. Flow comes from the
file patterns, from one batched provider for all six faces, or from one
streaming provider per face position (``flow_provider_factory``).

All indexing here is by processing position pos 0..5 (the reference's
``last_segments``); ``PROC_ORDER[pos]`` is the face number in file names.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import io
from ..core.config import StylizeOptions, format_flow_name
from ..ops import filters, strip_warp_kernel, warp
from ..utils import pipeline, profiling
from . import vr_geometry as vr
from .engine import StylizerEngine
from .evaluation import write_eval_file

PROC_ORDER = (6, 1, 2, 5, 3, 4)


@dataclasses.dataclass
class VROptions(StylizeOptions):
    start_frame: int = 1
    overlap_pixel_w: int = 20
    overlap_pixel_h: int = 20
    out_equi: bool = False
    out_equi_w: int = 768
    out_equi_h: int = 768
    out_cubemap: bool = False
    smooth_certainty: bool = False
    create_inconsistent_border: bool = False
    no_consistency_eval: bool = False
    # the border warps: None or True = kernel K5 where the map is separable
    # (its plain version on the CPU), False = the exact strip gather
    pallas_strip_warp: Optional[bool] = None


class _Geometry:
    """Per-face-size warp maps, their strip warps and the blend masks
    (fast_artistic_video_vr.lua:164-197), the masks on `device`."""

    def __init__(self, hplus: int, wplus: int, opt: VROptions, device):
        ow, oh = opt.overlap_pixel_w, opt.overlap_pixel_h
        self.hplus, self.wplus = hplus, wplus
        self.map_left = vr.perspective_warp_map_left(hplus, ow, wplus)
        self.map_right = vr.perspective_warp_map_right(hplus, ow, wplus)
        self.map_top = vr.perspective_warp_map_top(wplus, oh, hplus)
        self.map_bottom = vr.perspective_warp_map_bottom(wplus, oh, hplus)

        def static(m):
            fn = (strip_warp_kernel.make_static_strip_warp(m)
                  if opt.pallas_strip_warp is not False else None)
            return fn if fn is not None else warp.make_static_warp(m)

        self.warp_left = static(self.map_left)
        self.warp_right = static(self.map_right)
        self.warp_top = static(self.map_top)
        self.warp_bottom = static(self.map_bottom)
        warps = (self.warp_left, self.warp_right, self.warp_top, self.warp_bottom)
        # the border priors and the cross-face blend, one K5 launch each
        # when every map has a strip warp
        self.borders = (strip_warp_kernel.StripSet(*warps)
                        if all(isinstance(w, strip_warp_kernel.StripWarp) for w in warps)
                        else strip_warp_kernel.BorderSums(*warps))

        ones = torch.ones((hplus, wplus, 1), device=device)
        self.mask_left = self.warp_left(ones)[..., 0]
        self.mask_right = self.warp_right(ones)[..., 0]
        self.mask_top = self.warp_top(ones)[..., 0]
        self.mask_bottom = self.warp_bottom(ones)[..., 0]
        msum = self.mask_left + self.mask_right + self.mask_top + self.mask_bottom
        self.mask_all_div = torch.clamp(msum, min=1.0)
        self.mask_all = torch.clamp(msum, max=1.0)

        # the reference insets the blend gradient 10 px inside the overlap;
        # clamped so overlaps smaller than that degrade gracefully
        gw, gh = max(1, ow - 10), max(1, oh - 10)
        zeros = torch.zeros
        gm_left = torch.cat([filters.gradient_mask_w_dec(hplus, gw),
                             zeros((hplus, wplus - gw))], dim=1)
        gm_right = torch.cat([zeros((hplus, wplus - gw)),
                              filters.gradient_mask_w_inc(hplus, gw)], dim=1)
        gm_top = torch.cat([filters.gradient_mask_h_dec(gh, wplus),
                            zeros((hplus - gh, wplus))], dim=0)
        gm_bottom = torch.cat([zeros((hplus - gh, wplus)),
                               filters.gradient_mask_h_inc(gh, wplus)], dim=0)
        self.grad_left, self.grad_right = gm_left.to(device), gm_right.to(device)
        self.grad_top, self.grad_bottom = gm_top.to(device), gm_bottom.to(device)
        self.grad_left_right = torch.maximum(self.grad_left, self.grad_right)
        self.grad_all = torch.maximum(self.grad_left_right,
                                      torch.maximum(self.grad_top, self.grad_bottom))

        self.equi_map = None
        if opt.out_equi:
            r = opt.median_filter // 2
            self.equi_map = vr.cube_to_equirectangular_map(
                wplus - 2 * r, hplus - 2 * r, ow - r, oh - r,
                opt.out_equi_w, opt.out_equi_h)


def _u8(x):
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


class VRDriver:
    def __init__(self, engine: StylizerEngine, opt: VROptions, eval_fn=None,
                 flow_provider_factory=None, batched_flow_provider=None):
        """eval_fn: called as eval_fn(driver, i) after each face
        (video.evaluation.VREvaluator), returning a row of floats or None;
        the rows go to opt.evaluation_file.

        flow_provider_factory: a zero-argument callable building a
        flow.provider.StreamingFlowProvider; one provider per face position
        (each face is its own temporal stream) replaces the flow and
        occlusion file patterns.

        batched_flow_provider: a flow.provider.BatchedStreamingFlowProvider
        computing all 6 face flows of a frame at once at frame start (only
        the border priors are sequential). It takes precedence over
        flow_provider_factory."""
        self.engine = engine
        self.opt = opt
        self.device = engine.device
        self.eval_fn = eval_fn
        self.eval_rows: List[List[float]] = []
        self.geo: Optional[_Geometry] = None
        self.segments: List[Optional[torch.Tensor]] = [None] * 6       # this frame
        self.prev_segments: List[Optional[torch.Tensor]] = [None] * 6  # previous, blended
        self.last_content: Optional[torch.Tensor] = None               # the face last loaded
        self.batched_flow = batched_flow_provider
        self.flow_providers = (
            [flow_provider_factory() for _ in range(6)]
            if flow_provider_factory is not None and batched_flow_provider is None
            else None)
        # streaming: flow and certainty come from _streamed, not from files
        self.streaming = self.flow_providers is not None or batched_flow_provider is not None
        self._streamed: List[Optional[tuple]] = [None] * 6
        self._border_certs: dict = {}

    # -- inputs -------------------------------------------------------------

    def _face_path(self, file_idx: int, pos: int) -> str:
        return self.opt.input_pattern % (file_idx, PROC_ORDER[pos])

    def _upload(self, u8: np.ndarray) -> torch.Tensor:
        """A uint8 face on the device as float32 [0, 1] (io.load_image's
        values: the division is the same float32 operation)."""
        if not u8.flags.writeable:     # a decoded file's read-only buffer
            u8 = u8.copy()
        return torch.from_numpy(u8).to(self.device).float() / 255.0

    def _geometry(self, face) -> _Geometry:
        if self.geo is None:
            self.geo = _Geometry(face.shape[0], face.shape[1], self.opt, self.device)
        return self.geo

    def _load_frame_faces(self, i: int) -> Optional[torch.Tensor]:
        """The 6 faces (6, H, W, 3) of the frame holding face index i, on
        the device, or None when a file is missing (the end of the video)."""
        file_idx = (i - 1) // 6 + self.opt.start_frame
        paths = [self._face_path(file_idx, pos) for pos in range(6)]
        if not all(os.path.exists(p) for p in paths):
            return None
        return self._upload(np.stack([io.load_image_u8(p) for p in paths]))

    def load_face(self, i: int) -> Optional[torch.Tensor]:
        pos = (i - 1) % 6
        file_idx = (i - 1) // 6 + self.opt.start_frame
        path = self._face_path(file_idx, pos)
        if not os.path.exists(path):
            return None
        img = self._upload(io.load_image_u8(path))
        self._geometry(img)
        self.last_content = img
        return img

    def _border_cert(self, pos: int):
        """The static neighbour-border certainty of a position (cached)."""
        if pos not in self._border_certs:
            g = self.geo
            border = torch.zeros((g.hplus, g.wplus), device=self.device)
            if not self.opt.create_inconsistent_border:
                if pos in (1, 3, 4, 5):
                    border = torch.maximum(border, g.mask_left)
                if pos in (2, 3, 4, 5):
                    border = torch.maximum(border, g.mask_right)
                if pos in (4, 5):
                    border = torch.maximum(border, g.mask_top)
                    border = torch.maximum(border, g.mask_bottom)
            self._border_certs[pos] = border
        return self._border_certs[pos]

    def load_cert(self, i: int):
        """Border certainty from the stylized neighbours, plus the occlusion
        map of the temporal prior (:204-237)."""
        opt = self.opt
        pos = (i - 1) % 6
        file_idx = (i - 1) // 6 + opt.start_frame
        border = self._border_cert(pos)
        if i < 7 or opt.create_inconsistent:
            return border
        if self.streaming:
            streamed = self._streamed[pos]
            if streamed is None:
                return border
            cert_frame = streamed[1]
        else:
            name = format_flow_name(opt.occlusions_pattern, file_idx - 1, file_idx)
            name = name % PROC_ORDER[pos] if "%" in name else name
            pipeline.wait_for_file(name)
            cert = io.load_image(name, num_channels=1)[..., 0]
            if opt.invert_occlusion:
                cert = 1.0 - cert
            cert_frame = torch.from_numpy(np.ascontiguousarray(cert)).to(self.device)
        return torch.maximum(cert_frame, border)

    def make_prior(self, i: int, cert_eroded):
        """Spatial border prior plus the temporal blend (:239-302).
        `cert_eroded` is the min-filtered certainty (the reference engine
        passes the eroded mask into this callback, core.lua:162,207)."""
        opt = self.opt
        pos = (i - 1) % 6
        file_idx = (i - 1) // 6 + opt.start_frame
        if not opt.create_inconsistent_border and pos > 0:
            border = self._border_prior(pos)
        else:
            border = torch.zeros((self.geo.hplus, self.geo.wplus, 3), device=self.device)
        if i < 7 or opt.create_inconsistent:
            return border
        band = None
        if self.streaming:
            streamed = self._streamed[pos]
            if streamed is None:
                return border
            flow = streamed[0]
            if not self.engine.config.exact_warp:
                band = (self.batched_flow.last_band if self.batched_flow is not None
                        else self.flow_providers[pos].last_band)
        else:
            name = format_flow_name(opt.flow_pattern, file_idx - 1, file_idx)
            name = name % PROC_ORDER[pos] if "%" in name else name
            pipeline.wait_for_file(name)
            flow_np = io.read_flo(name)
            if not self.engine.config.exact_warp:
                band = warp.flow_band(float(np.abs(flow_np).max()))
            flow = torch.from_numpy(flow_np).to(self.device)
        return self._temporal_blend(pos, band, self.prev_segments[pos], flow,
                                    border, cert_eroded)

    def _border_prior(self, pos: int):
        """The border prior of a position from the faces of this frame
        already stylized (zeros for the others)."""
        g = self.geo
        return g.borders.prior(pos, self.segments[:4], g.mask_all_div)

    def _temporal_blend(self, pos: int, band, prev_seg, flow, border, cert_eroded):
        """The previous blended face warped by the flow (banded warp, band
        None: the exact gather), blended with the border prior through the
        gradient masks where the neighbours' borders are certain
        (:275-295)."""
        prev_warped = warp.bilinear_warp(prev_seg, flow, band=band)
        if pos == 0:
            return prev_warped
        g = self.geo
        gm = [None, g.grad_right, g.grad_left, g.grad_left_right, g.grad_all, g.grad_all][pos]
        mk = [None, g.mask_left, g.mask_right, g.mask_left + g.mask_right,
              g.mask_all, g.mask_all][pos]
        mask = (torch.maximum(gm, torch.ceil(gm) * (1.0 - cert_eroded)) * mk)[..., None]
        return prev_warped * (1.0 - mask) + border * mask

    def smooth_cert_mask(self, pos: int):
        """The optional flow_mask of the reference prior callback
        (:296-301): a blocky >= 0.25 mask from the gradient mask."""
        g = self.geo
        grad = [None, g.grad_right, g.grad_left, g.grad_left_right,
                g.grad_all, g.grad_all][pos]
        if grad is None:
            return None
        return torch.clamp(torch.sign(torch.clamp(grad - 0.5, min=0.0)), min=0.25)

    def _face_step(self, i: int, img):
        """One face after the first: border certainty (with the occlusion
        map from the second frame on), its erosion, the border prior and
        the temporal blend, and the engine's prior-conditioned stylization
        (the JAX package runs the same math as one fused program)."""
        opt = self.opt
        with profiling.span("vr.prior"):
            cert_eroded = filters.min_filter(self.load_cert(i), opt.occlusions_min_filter)
            prior = self.make_prior(i, cert_eroded)
            input_mask = cert_eroded
            if opt.smooth_certainty:
                fm = self.smooth_cert_mask((i - 1) % 6)
                if fm is not None:
                    input_mask = torch.minimum(cert_eroded, fm)
        return self.engine.stylize_with_prior(img, prior.float(), input_mask,
                                              erode_cert=False)

    # -- outputs ------------------------------------------------------------

    @profiling.traced("vr.blend")
    def blend_other_sides(self) -> List[torch.Tensor]:
        """The cross-face blend after a full frame (:454-509): 24 border
        warps, one K5 launch in all when every map has a strip warp."""
        g = self.geo
        return g.borders.blend(self.segments, g.grad_all, g.mask_all_div)

    @profiling.traced("vr.outputs")
    def _outputs(self, segments):
        """uint8 faces, and the median-filtered equirectangular and cubemap
        images when asked for, on the device."""
        opt = self.opt
        faces_u8 = [_u8(s) for s in segments]
        equi_u8 = cubemap_u8 = None
        if not (opt.out_equi or opt.out_cubemap):
            return faces_u8, equi_u8, cubemap_u8
        mf = opt.median_filter
        r = mf // 2
        sides = [filters.median_filter(s, mf) for s in segments] if mf > 0 else list(segments)
        if opt.out_equi and self.geo.equi_map is not None:
            strip = torch.cat([sides[0], sides[1], sides[2], sides[3],
                               vr.rotate180(sides[4]), vr.rotate180(sides[5])], dim=1)
            equi_u8 = _u8(warp.make_static_warp(self.geo.equi_map)(strip))
        if opt.out_cubemap:
            ow = opt.overlap_pixel_w // 2 - r
            oh = opt.overlap_pixel_h // 2 - r

            def crop(x):
                return x[oh:x.shape[0] - oh, ow:x.shape[1] - ow]

            cubemap_u8 = _u8(torch.cat(
                [crop(sides[3]), crop(sides[0]), crop(vr.rotate90(sides[4])),
                 crop(vr.rotate_minus90(sides[5])), crop(sides[2]), crop(sides[1])],
                dim=1))
        return faces_u8, equi_u8, cubemap_u8

    def _save_frame_outputs(self, file_idx: int, writer) -> None:
        """Blend and build the outputs on the device, then download, encode
        and write them on the writer thread."""
        prefix = self.opt.output_prefix
        self.prev_segments = self.blend_other_sides()
        faces_u8, equi_u8, cubemap_u8 = self._outputs(self.prev_segments)

        def save():
            for pos in range(6):
                self.save(f"{prefix}{file_idx}_{pos}.png", faces_u8[pos].cpu().numpy())
            if equi_u8 is not None:
                self.save(f"{prefix}-{file_idx:05d}_equi.png", equi_u8.cpu().numpy())
            if cubemap_u8 is not None:
                self.save(f"{prefix}-{file_idx:05d}_cubemap.png", cubemap_u8.cpu().numpy())

        writer.put(save)

    def save(self, path: str, u8: np.ndarray) -> None:
        io.save_image(path, u8)

    # -- main loop ----------------------------------------------------------

    def _is_single(self, i: int) -> bool:
        if self.opt.create_inconsistent:
            return i % 6 == 1
        return i == 1

    @torch.no_grad()
    def run(self, progress: bool = True) -> int:
        """Stylize the video; returns the number of faces processed."""
        opt = self.opt
        n_indices = opt.num_frames * 6
        start = 1
        if opt.continue_with > 1:
            # resume: reload the previous frame's blended faces (:576-583)
            for pos in range(6):
                path = f"{opt.output_prefix}{opt.continue_with}_{pos}.png"
                self.prev_segments[pos] = self._upload(io.load_image_u8(path))
            start = opt.continue_with * 6 + 1
            if self.load_face(start) is None:
                return 0
            # prime the flow provider(s) with the last completed frame's
            # input faces, so the resumed frame gets real flow and
            # certainty and warps the reloaded faces
            prev_faces = self._load_frame_faces((opt.continue_with - opt.start_frame) * 6 + 1)
            if prev_faces is not None and self.batched_flow is not None:
                self.batched_flow(prev_faces)
            elif prev_faces is not None and self.flow_providers is not None:
                for pos in range(6):
                    self.flow_providers[pos](prev_faces[pos])
        count = 0
        use_batched = self.batched_flow is not None and not opt.create_inconsistent
        prefetch = None
        if use_batched:
            # frame-level lookahead: the next frame's 6 faces load and upload
            # on the prefetch thread while this frame runs (`start` is always
            # at pos 0)
            n_frames = (n_indices - start) // 6 + 1

            def load(k):
                i = start + k * 6
                with profiling.keyed(0, (i - 1) // 6 + opt.start_frame):
                    return self._load_frame_faces(i)

            prefetch = iter(pipeline.Prefetcher(load, range(max(0, n_frames))))
        frame_faces = None
        writer = pipeline.AsyncWriter(depth=2)
        try:
            for i in range(start, n_indices + 1):
                file_idx = (i - 1) // 6 + opt.start_frame
                with profiling.keyed(0, file_idx):
                    pos = (i - 1) % 6
                    if use_batched:
                        if pos == 0 or frame_faces is None:
                            got = next(prefetch, None)
                            if got is None:
                                break
                            frame_faces = got[1]
                            self._geometry(frame_faces[0])
                            out = self.batched_flow(frame_faces)
                            self._streamed = list(out) if out is not None else [None] * 6
                        img = self.last_content = frame_faces[pos]
                        t0 = time.monotonic()
                    else:
                        img = self.load_face(i)
                        if img is None:
                            break
                        t0 = time.monotonic()
                        if self.flow_providers is not None and not opt.create_inconsistent:
                            self._streamed[pos] = self.flow_providers[pos](img)
                    if self._is_single(i):
                        stylized = self.engine.stylize_first(img)
                    else:
                        stylized = self._face_step(i, img)
                    self.segments[pos] = stylized
                    if progress:
                        print(f"frame {file_idx} face {PROC_ORDER[pos]}: "
                              f"{(time.monotonic() - t0) * 1000:.1f} ms")
                    if self.eval_fn is not None:
                        row = self.eval_fn(self, i)
                        if row is not None:
                            self.eval_rows.append(list(row))
                    if pos == 5:
                        self._save_frame_outputs(file_idx, writer)
                    count += 1
        finally:
            writer.close()
        if self.eval_rows and opt.evaluation_file:
            write_eval_file(opt.evaluation_file, self.eval_rows)
        return count
