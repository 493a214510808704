"""K5: the static separable-projective strip warp of the VR border maps —
wrapper of ``csrc/strip_warp.cu`` and its plain PyTorch version.

Replaces ``fast_artistic_videos_tpu/ops/warp_pallas.py`` ``_strip_kernel``
(factory ``make_static_strip_warp``). The VR border maps
(``video/vr_geometry.py``) touch only an overlap-wide strip of the output,
and their projective structure makes one source coordinate constant along
one axis: the left/right maps' source column depends on the output column
only, the top/bottom maps' source row on the output row only. The factory
checks that structure on the host (returning None when it is absent, so the
caller falls back to ``ops.warp.make_static_warp``) and builds static
tables over the output's bounding box of mapped pixels:

  * the "line" axis (output column for left/right, output row for
    top/bottom): one source index (floor) and its bilinear fraction;
  * the "pixel" axis: per output pixel, the source index (floor) on the
    other axis and its fraction. Unmapped pixels get an index whose two taps
    both lie outside the image, so they read zero.

Then, per output pixel, with p the pixel-axis taps and q the line-axis taps:

    A(p) = (1 - fq) * S(p, q0) + fq * S(p, q0 + 1)
    out  = (1 - fp) * A(p0)    + fp * A(p0 + 1)

(the Pallas kernel's column stage, then its 2-tap row resample), where S
reads zero outside the source image. That equals ``bilinear_warp(img,
map)`` on these maps. The output is the whole (Ho, Wo, C) frame in float32,
zero outside the strip; the input is float32 or bfloat16.

The VR driver sums these warps: a face's border prior (up to four warps of
the faces already done) and, after each frame, the cross-face blend (four
warps for each of the six faces). :class:`StripSet` computes each of those
in ONE launch of the summing entry ``fav_strip_warp_sum`` (rotations folded
into the source index, the term list in the launch's parameter block);
its plain version is the composition :func:`compose_prior` /
:func:`compose_blend` of the single-map plain warps, the
``video/vr_geometry`` rotations and the same torch operations, which
:class:`BorderSums` also runs over any four single-map warps (the exact
strip gather where a map is not separable).
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ..utils import profiling
from ..video import vr_geometry as vr
from ._build import Kernel, no_grad_inputs, ptr

KERNEL = Kernel("strip_warp", "fast_artistic_videos_tpu_torch/csrc/strip_warp.cu",
                "fast_artistic_videos_tpu/ops/warp_pallas.py:142", "kernel.K5")

_UNMAPPED = -4      # a floor index whose two taps both fall outside the image
L, R, T, B = range(4)           # the left, right, top and bottom border maps
R90, RM90, R180 = 1, 2, 3       # rotations as the summing entry codes them


class StripWarp:
    """The warp of one static map: ``warp(img)`` with img (H, W, C) or
    (N, H, W, C) (a batch shares the map) returns float32 (Ho, Wo, C) or
    (N, Ho, Wo, C). A CPU tensor runs the plain version; a CUDA tensor
    launches kernel K5 or raises. The tables are uploaded once per device,
    at the first call on it."""

    def __init__(self, out_hw, box, transposed, pix_src, pix_frac, line_src, line_frac):
        self.out_hw = tuple(out_hw)
        self.box = box                      # (y0, y1, x0, x1) of the output
        self.transposed = transposed        # True: the line axis is the row
        self._host = (pix_src, pix_frac, line_src, line_frac)
        self._tables = {}
        self._lock = threading.Lock()

    def tables(self, device):
        """(pix_src int32, pix_frac f32, line_src int32, line_frac f32) on
        `device`, the pixel tables (bh, bw) over the box in the output frame."""
        got = self._tables.get(device)       # no lock once they exist
        if got is not None:
            return got
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            got = self._tables.get(device)
            if got is None:
                got = tuple(torch.from_numpy(a).to(device) for a in self._host)
                self._tables[device] = got
            return got

    def __call__(self, img):
        no_grad_inputs("strip_warp", img)
        if img.device.type == "cpu":
            return self.plain(img)
        if img.device.type != "cuda":
            raise ValueError(f"strip_warp: img on {img.device}")
        return self.kernel(img)

    def _batch(self, img):
        if img.ndim not in (3, 4):
            raise ValueError(f"strip_warp: img must be HWC or NHWC, got {tuple(img.shape)}")
        return img.ndim == 3, (img[None] if img.ndim == 3 else img)

    def plain(self, img, rot: int = 0):
        """The same tables, applied with torch indexing in float32, to img
        rotated by `rot` (0, R90, RM90 or R180) through the source
        index as the summing entry does it (:func:`rotated_source`), with
        no rotated copy: ``plain(img, rot)`` equals ``plain(rotate(img))``."""
        single, x = self._batch(img)
        n, h, w, c = x.shape
        hr, wr = (w, h) if rot in (R90, RM90) else (h, w)     # the rotated image
        y0, y1, x0, x1 = self.box
        pix_src, pix_frac, line_src, line_frac = self.tables(x.device)
        bh, bw = y1 - y0, x1 - x0
        line_src = line_src.long()
        line_src = line_src[:, None] if self.transposed else line_src[None, :]
        line_frac = line_frac[:, None] if self.transposed else line_frac[None, :]
        pix_src = pix_src.long()
        flat = x.float().reshape(n, h * w, c)
        p_end, q_end = (wr, hr) if self.transposed else (hr, wr)

        def tap(p, q):
            """S(p, q): pixel-axis index p, line-axis index q, zero outside."""
            p, q = torch.broadcast_tensors(p, q)
            ok = (p >= 0) & (p < p_end) & (q >= 0) & (q < q_end)
            r, col = (q, p) if self.transposed else (p, q)
            r, col = rotated_source(rot, r.clamp(0, hr - 1), col.clamp(0, wr - 1), h, w)
            idx = (r * w + col).reshape(-1)
            vals = flat[:, idx].reshape(n, bh, bw, c)
            return vals * ok[None, ..., None]

        fq = line_frac[None, ..., None]
        fp = pix_frac[None, ..., None]
        a0 = (1.0 - fq) * tap(pix_src, line_src) + fq * tap(pix_src, line_src + 1)
        a1 = (1.0 - fq) * tap(pix_src + 1, line_src) + fq * tap(pix_src + 1, line_src + 1)
        strip = (1.0 - fp) * a0 + fp * a1
        out = flat.new_zeros((n,) + self.out_hw + (c,))
        out[:, y0:y1, x0:x1] = strip
        return out[0] if single else out

    def kernel(self, img):
        """K5 on a CUDA tensor: one launch writes the whole output frame."""
        single, x = self._batch(img)
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"strip_warp: unsupported dtype {x.dtype}")
        x = x.contiguous()
        n, h, w, c = x.shape
        pix_src, pix_frac, line_src, line_frac = self.tables(x.device)
        y0, y1, x0, x1 = self.box
        out = torch.empty((n,) + self.out_hw + (c,), dtype=torch.float32, device=x.device)
        if out.numel():
            KERNEL.call("fav_strip_warp", x.device, ptr(x), ptr(pix_src), ptr(pix_frac),
                        ptr(line_src), ptr(line_frac), ptr(out), n, h, w, c,
                        self.out_hw[0], self.out_hw[1], y0, x0, y1 - y0, x1 - x0,
                        int(self.transposed), int(x.dtype == torch.bfloat16))
        return out[0] if single else out


def rotated_source(rot: int, r, c, h: int, w: int):
    """(row, column) in an (h, w) source image of pixel (r, c) of that image
    rotated by `rot`, as ``video/vr_geometry.py`` rotates it: rotate90 (R90)
    is a transpose then a flip of the rows, rotate_minus90 (RM90) a
    transpose then a flip of the columns, rotate180 (R180) both flips. The
    summing entry of csrc/strip_warp.cu folds the rotation into its taps by
    the same map."""
    if rot == R90:
        return c, w - 1 - r
    if rot == RM90:
        return h - 1 - c, r
    if rot == R180:
        return h - 1 - r, w - 1 - c
    return r, c


# the border sums of the VR driver (video/driver_vr.py, after
# fast_artistic_video_vr.lua:239-272 and :454-509): terms (map, rotation,
# segment)
_ROTATE = (lambda x: x, vr.rotate90, vr.rotate_minus90, vr.rotate180)
PRIOR_TERMS = {
    1: ((L, 0, 0),),
    2: ((R, 0, 0),),
    3: ((L, 0, 1), (R, 0, 2)),
    4: ((L, R90, 1), (R, RM90, 2), (T, 0, 3), (B, R180, 0)),
    5: ((L, RM90, 1), (R, R90, 2), (T, R180, 0), (B, 0, 3)),
}
PRIOR_DIVIDES = (4, 5)          # positions whose terms are each divided by div
BLEND_TERMS = (
    ((R, 0, 1), (L, 0, 2), (B, R180, 4), (T, R180, 5)),
    ((L, 0, 0), (R, 0, 3), (B, RM90, 4), (T, R90, 5)),
    ((R, 0, 0), (L, 0, 3), (B, R90, 4), (T, RM90, 5)),
    ((L, 0, 1), (R, 0, 2), (B, 0, 4), (T, 0, 5)),
    ((B, R180, 0), (L, R90, 1), (R, RM90, 2), (T, 0, 3)),
    ((T, R180, 0), (L, RM90, 1), (R, R90, 2), (B, 0, 3)),
)


def compose_prior(warps, pos: int, segments, div):
    """The border prior of processing position `pos` (1-5) from four
    single-map warps (left, right, top, bottom) and the faces of this frame
    already stylized (`segments`, None where not yet done: zeros): the sum
    of its warped terms, each divided by div (H, W) at positions 4 and 5."""
    zero = None
    terms = []
    for m, rot, i in PRIOR_TERMS[pos]:
        src = segments[i]
        if src is None:
            if zero is None:
                zero = torch.zeros(tuple(div.shape) + (3,), device=div.device)
            src = zero
        t = warps[m](_ROTATE[rot](src))
        terms.append(t / div[..., None] if pos in PRIOR_DIVIDES else t)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def compose_blend(warps, segments, gm, div):
    """The cross-face blend of the six faces: per face, the sum of its four
    warped neighbour borders divided by div, blended in through the
    gradient mask gm (both (H, W)). Returns the six blended faces."""
    gm, div = gm[..., None], div[..., None]
    out = []
    for p, terms in enumerate(BLEND_TERMS):
        a, b, c, d = (warps[m](_ROTATE[rot](segments[i])) for m, rot, i in terms)
        out.append(segments[p] * (1 - gm) + (a + b + c + d) / div * gm)
    return out


class BorderSums:
    """The VR driver's border prior and cross-face blend composed from four
    single-map warps (any callables: the exact strip gather of
    ``ops.warp.make_static_warp`` where a map is not separable)."""

    def __init__(self, left, right, top, bottom):
        self.warps = (left, right, top, bottom)

    def prior(self, pos: int, segments, div):
        return compose_prior(self.warps, pos, segments, div)

    def blend(self, segments, gm, div):
        return compose_blend(self.warps, segments, gm, div)


class _SumLayout:
    """Offsets into the int64 image of csrc/strip_warp.cu's SumArgs."""
    MAP = 9                         # fields of a SumMap
    TERM = 5                        # of a SumTerm
    DST = 4 + 4 * TERM              # of a SumDst
    DSTS = 4 * MAP
    TAIL = DSTS + 6 * DST           # div, gm, out, ndst, h, w, mode
    SIZE = TAIL + 7


class StripSet(BorderSums):
    """The four border maps' :class:`StripWarp`s, summed by kernel K5's
    summing entry: one launch per border prior and one per cross-face
    blend (all six faces). CPU tensors run the plain composition; CUDA
    tensors launch the kernel or raise."""

    def __init__(self, left, right, top, bottom):
        super().__init__(left, right, top, bottom)
        self.plain_warps = tuple(w.plain for w in self.warps)
        self._templates = {}

    def prior(self, pos: int, segments, div):
        """Position `pos`'s border prior, float32 (H, W, 3)."""
        no_grad_inputs("strip_warp_sum", div, *segments)
        if div.device.type == "cpu":
            return self.prior_plain(pos, segments, div)
        mode = 1 if pos in PRIOR_DIVIDES else 0
        with profiling.span(KERNEL.span):
            return self._launch((PRIOR_TERMS[pos],), segments, div, None, mode)[0]

    def blend(self, segments, gm, div):
        """The six blended faces, float32 (H, W, 3) each (views of one
        (6, H, W, 3) tensor on a card)."""
        no_grad_inputs("strip_warp_sum", gm, div, *segments)
        if div.device.type == "cpu":
            return self.blend_plain(segments, gm, div)
        with profiling.span(KERNEL.span):
            return list(self._launch(BLEND_TERMS, segments, div, gm, 2).unbind(0))

    def prior_plain(self, pos: int, segments, div):
        return compose_prior(self.plain_warps, pos, segments, div)

    def blend_plain(self, segments, gm, div):
        return compose_blend(self.plain_warps, segments, gm, div)

    def _template(self, device):
        """The SumArgs image with the four maps' tables on `device`."""
        got = self._templates.get(device)
        if got is None:
            got = np.zeros(_SumLayout.SIZE, np.int64)
            for m, wp in enumerate(self.warps):
                y0, y1, x0, x1 = wp.box
                tables = [t.data_ptr() for t in wp.tables(device)]
                got[m * _SumLayout.MAP:(m + 1) * _SumLayout.MAP] = tables + [
                    y0, x0, y1 - y0, x1 - x0, int(wp.transposed)]
            self._templates[device] = got
        return got

    def _launch(self, dsts, segments, div, gm, mode: int):
        """One launch over the destinations `dsts` (term lists); mode 0 sums
        the terms, 1 sums each term divided by div, 2 blends the sum / div
        into segment d through gm (destination d is segment d)."""
        if div.device.type != "cuda":
            raise ValueError(f"strip_warp: div on {div.device}")
        device = div.device
        h, w = div.shape
        if any(wp.out_hw != (h, w) for wp in self.warps):
            raise ValueError(f"strip_warp: maps of {self.warps[0].out_hw}, faces of {(h, w)}")

        copies = []         # faces whose rows were not contiguous, alive until the launch

        def face(t):
            """(data pointer, bfloat16, row stride) of an (H, W, 3) face."""
            if (t.device != device or t.shape != (h, w, 3)
                    or t.dtype not in (torch.float32, torch.bfloat16)):
                raise ValueError(f"strip_warp: a face must be ({h}, {w}, 3) float32 or "
                                 f"bfloat16 on {device}, got {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}")
            if t.stride()[1:] != (3, 1):
                t = t.contiguous()
                copies.append(t)
            return t.data_ptr(), int(t.dtype == torch.bfloat16), t.stride()[0]

        for t in (div, gm):
            if t is not None and (t.device != device or t.shape != (h, w)
                                  or t.dtype != torch.float32 or not t.is_contiguous()):
                raise ValueError("strip_warp: div and gm must be contiguous float32 (H, W)")
        lay = _SumLayout
        args = self._template(device).copy()
        faces = [face(t) if t is not None else None for t in segments]
        for d, terms in enumerate(dsts):
            base = lay.DSTS + d * lay.DST
            if mode == 2:
                args[base:base + 3] = faces[d]
            k = 0
            for m, rot, i in terms:
                if faces[i] is None:            # a face not yet done: its warp is 0
                    continue
                src, bf16, row = faces[i]
                o = base + 4 + k * lay.TERM
                args[o:o + lay.TERM] = (src, m, rot, bf16, row)
                k += 1
            args[base + 3] = k
        out = torch.empty((len(dsts), h, w, 3), dtype=torch.float32, device=device)
        args[lay.TAIL:lay.SIZE] = (div.data_ptr(), ptr(gm) or 0, out.data_ptr(), len(dsts),
                                   h, w, mode)
        KERNEL.call("fav_strip_warp_sum", device, args.ctypes.data)
        return out


def make_static_strip_warp(map_np, sentinel: float = 9999.0):
    """K5's factory for a static offset map (H, W, 2) (dx, dy): a
    :class:`StripWarp`, or None when the map is not separable-projective in
    either orientation (the host analysis of the JAX package's
    ``warp_pallas.make_static_strip_warp``)."""
    with warnings.catch_warnings():     # all-NaN columns of unmapped pixels
        warnings.simplefilter("ignore", RuntimeWarning)
        return _analyse(np.asarray(map_np, np.float64), sentinel)


def _analyse(map_np, sentinel):
    ho_f, wo_f = map_np.shape[:2]
    mapped_f = np.all(np.abs(map_np) < sentinel / 2, axis=-1)
    if not mapped_f.any():
        return None
    rows_any = np.where(mapped_f.any(axis=1))[0]
    cols_any = np.where(mapped_f.any(axis=0))[0]
    y0, y1 = int(rows_any[0]), int(rows_any[-1]) + 1
    x0, x1 = int(cols_any[0]), int(cols_any[-1]) + 1
    sub = map_np[y0:y1, x0:x1]
    mapped = mapped_f[y0:y1, x0:x1]
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    asx = np.where(mapped, xx + sub[..., 0], np.nan)  # absolute source col
    asy = np.where(mapped, yy + sub[..., 1], np.nan)  # absolute source row

    def col_constant(a):
        rng = np.nanmax(a, axis=0) - np.nanmin(a, axis=0)
        return np.nanmax(rng) < 1e-3 if np.isfinite(rng).any() else False

    def row_constant(a):
        return col_constant(a.T)

    if col_constant(asx):
        transposed = False            # line = output column -> source column
        line_coord, line_axis, pix_coord = asx, 0, asy
    elif row_constant(asy):
        transposed = True             # line = output row -> source row
        line_coord, line_axis, pix_coord = asy, 1, asx
    else:
        return None
    line_v = np.nanmax(line_coord, axis=line_axis)   # constant where mapped
    line_ok = np.isfinite(line_v)
    lv = np.where(line_ok, line_v, 0.0)
    line_src = np.where(line_ok, np.floor(lv), _UNMAPPED).astype(np.int32)
    line_frac = np.where(line_ok, lv - np.floor(lv), 0.0).astype(np.float32)
    pv = np.where(mapped, pix_coord, 0.0)
    pix_src = np.where(mapped, np.floor(pv), _UNMAPPED).astype(np.int32)
    pix_frac = np.where(mapped, pv - np.floor(pv), 0.0).astype(np.float32)
    return StripWarp((ho_f, wo_f), (y0, y1, x0, x1), transposed,
                     np.ascontiguousarray(pix_src), np.ascontiguousarray(pix_frac),
                     line_src, line_frac)
