"""The temporally consistent recurrence in plain float32 PyTorch: the
benchmark's reference for the 2D streams and the 360° cube faces.

A frozen copy of the arithmetic of fast-artistic-videos' video engine as
the port's plain path computes it. Per 2D frame: the certainty (eroded by a
7x7 window), the previous stylized frame warped by the backward flow
(banded two-pass warp), masked by the certainty, the 7-channel VGG-space
input (content, masked prior, certainty), the network, de-processing and
uint8 quantization. Per 360° frame (six 922-px faces, 128-px overlap;
``fast_artistic_video_vr.lua``): the faces in the order (6, 1, 2, 5, 3, 4),
each with the border certainty and border prior of the faces of the same
frame already stylized, from the second frame on blended with its previous
blended face warped by flow, then the cross-face blend of all six and the
uint8 faces. A stream runs from its first frame, or ``resume``s from a
carried state. Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import flow as flow_ref
from . import stylizer as net_ref
from . import vr_maps


def _pad_edge(x, hp: int, wp: int):
    h, w = x.shape[0], x.shape[1]
    if (hp, wp) == (h, w):
        return x
    rows = torch.arange(hp, device=x.device).clamp(max=h - 1)
    cols = torch.arange(wp, device=x.device).clamp(max=w - 1)
    return x[rows][:, cols]


def _pad_zero(x, hp: int, wp: int):
    out = x.new_zeros((hp, wp) + tuple(x.shape[2:]))
    out[:x.shape[0], :x.shape[1]] = x
    return out


class Stylize:
    """The network's two entries on one frame: alone (a zero prior and
    zero certainty), and with a prior image and certainty. Frames are
    padded at the bottom and right to the net's stride multiple (edge
    replication; the certainty with zeros) and the result cropped back."""

    def __init__(self, params, net: net_ref.Net):
        self.params, self.net = params, net

    def _round(self, v: int) -> int:
        m = self.net.total_stride
        return -(-v // m) * m

    def _run(self, content01, prior_rgb, cert):
        h, w = content01.shape[:2]
        hp, wp = self._round(h), self._round(w)
        c = net_ref.preprocess(_pad_edge(content01, hp, wp))
        if prior_rgb is None:
            x = torch.cat([c, torch.zeros((hp, wp, 4), device=c.device)], dim=-1)
        else:
            cert1 = _pad_zero(cert, hp, wp)[..., None]
            prior = net_ref.preprocess(_pad_edge(prior_rgb, hp, wp)) * cert1
            x = torch.cat([c, prior, cert1], dim=-1)
        y = net_ref.forward(self.params, self.net, x[None])[0]
        return torch.clamp(net_ref.deprocess(y), 0.0, 1.0)[:h, :w]

    def first(self, content01):
        return self._run(content01, None, None)

    def with_prior(self, content01, prior_rgb, cert):
        return self._run(content01, prior_rgb, cert)


class Stream2D:
    """One 2D stream, its flow by the flow family `flow`
    (``reference/flow_<model>.py``). ``step(frame_u8)`` takes the next
    (H, W, 3) uint8 frame as a tensor and returns its stylized uint8
    frame."""

    def __init__(self, params, net, flow, flow_params, flow_scale: float, min_filter: int = 7):
        self.stylize = Stylize(params, net)
        self.flow = flow_ref.StreamingFlow(flow, flow_params, flow_scale, erode=min_filter)
        self.prev: Optional[torch.Tensor] = None

    @torch.no_grad()
    def resume(self, state, history):
        """Continue from a carried stylized frame: the flow sees the frames
        before the next one, the prior is `state`."""
        for f in history:
            self.flow(f[None])
        self.prev = state

    @torch.no_grad()
    def step(self, frame_u8):
        content = frame_u8.float() / 255.0
        fc = self.flow(frame_u8[None])
        if fc is None or self.prev is None:
            out = self.stylize.first(content)
        else:
            flows, certs, band = fc
            prior = flow_ref.banded_warp(self.prev[None], flows, band)[0]
            out = self.stylize.with_prior(content, prior, certs[0])
        self.prev = out
        return net_ref.quantize(out)


# the processing order's border terms (fast_artistic_video_vr.lua:239-272,
# :454-509): (map, rotation, position), maps L, R, T, B, rotations none,
# +90, -90, 180
L, R, T, B = range(4)
PRIOR_TERMS = {
    1: ((L, 0, 0),),
    2: ((R, 0, 0),),
    3: ((L, 0, 1), (R, 0, 2)),
    4: ((L, 1, 1), (R, 2, 2), (T, 0, 3), (B, 3, 0)),
    5: ((L, 2, 1), (R, 1, 2), (T, 3, 0), (B, 0, 3)),
}
BLEND_TERMS = (
    ((R, 0, 1), (L, 0, 2), (B, 3, 4), (T, 3, 5)),
    ((L, 0, 0), (R, 0, 3), (B, 2, 4), (T, 1, 5)),
    ((R, 0, 0), (L, 0, 3), (B, 1, 4), (T, 2, 5)),
    ((L, 0, 1), (R, 0, 2), (B, 0, 4), (T, 0, 5)),
    ((B, 3, 0), (L, 1, 1), (R, 2, 2), (T, 0, 3)),
    ((T, 3, 0), (L, 2, 1), (R, 1, 2), (B, 0, 3)),
)


def _rotate(x, rot: int):
    if rot == 1:
        return x.transpose(0, 1).flip(0)
    if rot == 2:
        return x.transpose(0, 1).flip(1)
    if rot == 3:
        return x.flip(0, 1)
    return x


def gather_warp(img, flow):
    """Exact bilinear warp of img (H, W, C) by the absolute offsets flow
    (H, W, 2) (dx, dy): floor corners, zero for every tap outside."""
    h, w, c = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32).view(h, 1)
    xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, w)
    xf, yf = xs + flow[..., 0], ys + flow[..., 1]
    x0, y0 = torch.floor(xf), torch.floor(yf)
    wx0, wy0 = 1.0 - (xf - x0), 1.0 - (yf - y0)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(h * w, c)

    def tap(yi, xi, weight):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)
        return flat[idx].reshape(h, w, c) * (weight * ok)[..., None]

    return (tap(y0i, x0i, wy0 * wx0) + tap(y0i, x0i + 1, wy0 * (1.0 - wx0))
            + tap(y0i + 1, x0i, (1.0 - wy0) * wx0)
            + tap(y0i + 1, x0i + 1, (1.0 - wy0) * (1.0 - wx0)))


class Faces:
    """One 360° clip as six synchronised face streams, their flow by the
    flow family `flow`. ``step(faces_u8)``
    takes the next (6, H, W, 3) uint8 faces (in processing order) and
    returns the six blended uint8 faces."""

    def __init__(self, params, net, flow, flow_params, flow_scale: float, face: int,
                 overlap: int, min_filter: int = 7, device="cuda"):
        self.stylize = Stylize(params, net)
        self.flow = flow_ref.StreamingFlow(flow, flow_params, flow_scale, erode=0)
        self.min_filter = min_filter
        maps = vr_maps.border_maps(face, overlap)
        self.maps = [torch.from_numpy(m).to(device) for m in maps]
        ones = torch.ones((face, face, 1), device=device)
        ml, mr, mt, mb = (gather_warp(ones, m)[..., 0] for m in self.maps)
        msum = ml + mr + mt + mb
        self.div = torch.clamp(msum, min=1.0)
        mask_all = torch.clamp(msum, max=1.0)
        gl, gr, gt, gb = (g.to(device) for g in vr_maps.gradient_masks(face, overlap))
        glr = torch.maximum(gl, gr)
        self.grad_all = torch.maximum(glr, torch.maximum(gt, gb))
        self.grad = [None, gr, gl, glr, self.grad_all, self.grad_all]
        self.mask = [None, ml, mr, ml + mr, mask_all, mask_all]
        zeros = torch.zeros((face, face), device=device)
        self.border_cert = [
            zeros,
            ml, mr, torch.maximum(ml, mr),
            torch.maximum(torch.maximum(torch.maximum(ml, mr), mt), mb),
            torch.maximum(torch.maximum(torch.maximum(ml, mr), mt), mb),
        ]
        self.prev: Optional[List[torch.Tensor]] = None

    def _warp(self, m: int, rot: int, img):
        return gather_warp(_rotate(img, rot), self.maps[m])

    def _border_prior(self, pos: int, segments):
        out = None
        for m, rot, i in PRIOR_TERMS[pos]:
            t = self._warp(m, rot, segments[i])
            if pos in (4, 5):
                t = t / self.div[..., None]
            out = t if out is None else out + t
        return out

    def _blend(self, segments):
        gm, div = self.grad_all[..., None], self.div[..., None]
        out = []
        for p, terms in enumerate(BLEND_TERMS):
            a, b, c, d = (self._warp(m, rot, segments[i]) for m, rot, i in terms)
            out.append(segments[p] * (1 - gm) + (a + b + c + d) / div * gm)
        return out

    @torch.no_grad()
    def resume(self, state, history):
        """Continue from the six carried blended faces: the flow sees the
        frames before the next one."""
        for f in history:
            self.flow(f)
        self.prev = list(state)

    @torch.no_grad()
    def step(self, faces_u8):
        streamed = self.flow(faces_u8)
        first = self.prev is None
        segments: List[Optional[torch.Tensor]] = [None] * 6
        for pos in range(6):
            content = faces_u8[pos].float() / 255.0
            if first and pos == 0:
                segments[0] = self.stylize.first(content)
                continue
            cert = self.border_cert[pos]
            if not first:
                cert = torch.maximum(streamed[1][pos], cert)
            cert = flow_ref.min_filter(cert, self.min_filter)
            if pos > 0:
                border = self._border_prior(pos, segments)
            else:
                border = torch.zeros(content.shape, device=content.device)
            prior = border
            if not first:
                warped = flow_ref.banded_warp(self.prev[pos][None], streamed[0][pos:pos + 1],
                                              streamed[2])[0]
                if pos == 0:
                    prior = warped
                else:
                    mask = (torch.maximum(self.grad[pos], torch.ceil(self.grad[pos]) * (1.0 - cert))
                            * self.mask[pos])[..., None]
                    prior = warped * (1.0 - mask) + border * mask
            segments[pos] = self.stylize.with_prior(content, prior, cert)
        self.prev = self._blend(segments)
        return torch.stack([net_ref.quantize(s) for s in self.prev])
