"""FlowNet 2.0 — the port's second flow estimator, behind the interface of
``flow.estimator.FlowEstimator`` so that both streaming providers run it
unchanged.

Ilg, Mayer, Saikia, Keuper, Dosovitskiy, Brox, "FlowNet 2.0: Evolution of
Optical Flow Estimation with Deep Networks", CVPR 2017: the estimator of the
reference's ``stylizeVideo_flownet.sh``. The layers follow the PyTorch
layout of NVIDIA/flownet2-pytorch (``models.py`` ``FlowNet2``;
``networks/FlowNetC.py``, ``FlowNetS.py``, ``FlowNetSD.py``,
``FlowNetFusion.py``), at the published widths (162.5 M parameters):

* conv(k, s): a zero-padded conv, pad (k - 1) / 2, bias, LeakyReLU(0.1);
  deconv: ConvTranspose(4, 2, pad 1), bias, LeakyReLU(0.1); up: the same
  transposed conv on a 2-channel flow with no activation, without bias in
  C, S and SD and with one in the fusion, as flownet2-pytorch has them (a
  bias is used where the checkpoint holds one); predict: a 3x3 conv to 2
  channels; iconv: a 3x3 conv; neither has an activation.
* input: a, b = each frame less the pair's per-channel mean over both
  (padded) frames, in [0, 1] units ((frame - mean) / 255 of 0-255 frames).
* FlowNetC (``flownetc``): towers conv1 7x7/2 3->64, conv2 5x5/2 ->128,
  conv3 5x5/2 ->256 with shared weights on a and b; the correlation of the
  two conv3 maps (kernel K7, ``ops.correlation_kernel``: displacements
  -20..20 in steps of 2, 441 channels, divided by C, LeakyReLU(0.1));
  conv_redir 1x1 256->32 on a's conv3; conv3_1 on [redir, corr] (473);
  conv4 /2 512, conv4_1, conv5 /2 512, conv5_1, conv6 /2 1024, conv6_1.
* FlowNetS (``flownets_1``, ``flownets_2``): input [a, b, warp(b, flow),
  flow / 20, |a - warp(b, flow)|] (12 channels), conv1 7x7/2 ->64, conv2
  5x5/2 ->128, conv3 5x5/2 ->256, conv3_1, then conv4 to conv6_1 as above.
* decoder of C and S, levels 6 to 2: flow6 = predict(conv6_1); concat_l =
  [encoder_l, deconv_l(concat_{l+1} or conv6_1), up(flow_{l+1})] (1026,
  770, 386, 194 channels), flow_l = predict(concat_l); flow2 is at 1/4.
* FlowNetSD (``flownets_d``): input [a, b], 3x3 convs conv0 ->64, conv1 /2
  ->64, conv1_1 ->128, conv2 /2, conv2_1, conv3 /2 ->256, conv3_1, conv4
  /2 ->512, conv4_1, conv5 /2, conv5_1, conv6 /2 ->1024, conv6_1; its
  decoder puts inter_conv_l (1026->512, 770->256, 386->128, 194->64)
  before each predict.
* between stages a stage's flow2 is multiplied by div_flow = 20 and
  upsampled x4 (bilinear); the SD flow is divided by 20 instead, as
  flownet2-pytorch's ``FlowNet2.forward`` has it.
* fusion (``flownetfusion``): input [a, sd flow, css flow, |sd flow|,
  |css flow|, |a - warp(b, sd flow)|, |a - warp(b, css flow)|] (11
  channels); conv0 3x3 ->64, conv1 /2 ->64, conv1_1 ->128, conv2 /2 ->128,
  conv2_1; predict_flow2, deconv1 128->32, concat1 [conv1_1, deconv1,
  up(flow2)] (162), inter_conv1 ->32, predict_flow1, deconv0 162->16,
  concat0 [conv0, deconv0, up(flow1)] (82), inter_conv0 ->16,
  predict_flow0: the flow at the input's resolution, in its pixels.

Conventions the published sources leave to the framework, which the
benchmark's reference (``portbench/reference/flow_flownet2.py``) shares:

* the x4 upsample: bilinear with ``align_corners=False``;
* the warps: the port's warp entry, ``ops.warp.bilinear_warp`` without a
  band (the exact gather; taps outside the image read zero). flownet2-
  pytorch's ``Resample2d`` could not be confirmed offline; this is a
  departure where it clamps at the border;
* the flow resolution: the frame at flow scale, edge-padded to a multiple
  of 64, where the Caffe deploy net resizes to one; the flow is cropped back.

The towers' conv1-conv3 of a and b have the same input and the same mean in
both directions, so they run once a pair; everything else runs for each
direction, the two directions of a pair as one batch. Convs are cuDNN's,
inside ``core.device.float32_convs`` (no TF32); with ``dtype=torch.bfloat16``
they run in bfloat16 (flows, warps and norms stay float32; K7 takes the
maps in float32). Nothing here reads the flow on the host.

Checkpoint: an npz of ``name/leaf`` keys (``w``, ``b``), names
``<net>.<layer>`` with ``<net>`` in ``NETS`` (flownet2-pytorch's module
names). Every 4-D kernel is stored as the PyTorch tensor transposed by (2,
3, 1, 0), as PWC-lite's are: a conv's OIHW as HWIO, a transposed conv's
(Cin, Cout, kh, kw) as (kh, kw, Cout, Cin). ``flow.estimator.load_params``
reads it; ``flow.family`` picks this class by its keys.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..ops import correlation_kernel
from ..ops import warp as warp_ops
from ..utils import profiling
from .estimator import _pad_edge, _scaled, resize_bilinear

NETS = ("flownetc", "flownets_1", "flownets_2", "flownets_d", "flownetfusion")
DIV_FLOW = 20.0
STRIDE = 64
# a key only FlowNet 2.0's checkpoints hold
MARKER = "flownetfusion.predict_flow0"

Params = Dict[str, Dict[str, torch.Tensor]]


def is_flownet2(params) -> bool:
    """Whether a flow parameter tree is FlowNet 2.0's."""
    return MARKER in params


def _pyramid_only(coarse_backward: bool, fast_check: bool) -> None:
    if coarse_backward or fast_check:
        raise ValueError("coarse_backward and fast_check are PWC-lite's pyramid options; "
                         "the FlowNet 2.0 estimator has no pyramid to cut short")


def _norm(x):
    """The L2 norm over the channels, (N, 1, H, W)."""
    return (x * x).sum(dim=1, keepdim=True).sqrt()


def _warp(img, flow):
    """img (N, C, H, W) sampled at x + flow (flow (N, 2, H, W), (dx, dy)) by
    the port's exact bilinear gather; NCHW in and out."""
    out = warp_ops.bilinear_warp(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


def _up4(flow):
    """A flow upsampled x4 (bilinear)."""
    return F.interpolate(flow, scale_factor=4, mode="bilinear", align_corners=False)


class FlowNet2Estimator:
    """FlowNet 2.0 with ``FlowEstimator``'s streaming interface: ``prep``
    gives a frame at flow scale, edge-padded to a multiple of 64; the
    refinements give both directions of a pair. On ``device`` (the card
    unless ``device="cpu"``); convs in ``dtype``."""

    # the streaming providers run this step eagerly, never from CUDA graphs:
    # the card, not the host, sets its pace, and its networks' spans
    # (flow.fn2.*) open only where their code runs
    capturable = False

    def __init__(self, params: Params, dtype=torch.float32, device=device_mod.DEFAULT):
        if not is_flownet2(params):
            raise ValueError("not a FlowNet 2.0 checkpoint: no " + MARKER)
        self.device = device_mod.resolve(device)
        self._dtype = dtype
        self.params = {name: {leaf: t.to(self.device, dtype) for leaf, t in leaves.items()}
                       for name, leaves in params.items()}

    # -- layers ---------------------------------------------------------------

    def _conv(self, name, x, stride=1, relu=True):
        p = self.params[name]
        k = p["w"].shape[-1]
        with device_mod.float32_convs():
            y = F.conv2d(x.to(self._dtype), p["w"], p["b"], stride, (k - 1) // 2)
        return F.leaky_relu(y, 0.1) if relu else y

    def _deconv(self, name, x, relu=True):
        p = self.params[name]
        with device_mod.float32_convs():
            y = F.conv_transpose2d(x.to(self._dtype), p["w"], p.get("b"), 2, 1)
        return F.leaky_relu(y, 0.1) if relu else y

    def _encoder(self, net, x, first):
        """The features of levels 2-6: the layers of `first` ((name,
        stride) pairs), then conv3_1 down to conv6_1."""
        feats = {}
        for name, stride in first:
            x = self._conv(f"{net}.{name}", x, stride)
            if name in ("conv2", "conv2_1"):
                feats[2] = x
        return self._down(net, x, feats)

    def _down(self, net, x, feats):
        x = self._conv(f"{net}.conv3_1", x)
        feats[3] = x
        for lvl in (4, 5, 6):
            x = self._conv(f"{net}.conv{lvl}", x, 2)
            x = self._conv(f"{net}.conv{lvl}_1", x)
            feats[lvl] = x
        return feats

    def _decoder(self, net, feats, inter: bool):
        """flow2 (float32, 1/4 resolution) from the features of levels 2-6."""
        x = feats[6]
        flow = self._conv(f"{net}.predict_flow6", x, relu=False)
        for lvl in (5, 4, 3, 2):
            up = self._deconv(f"{net}.upsampled_flow{lvl + 1}_to_{lvl}", flow, relu=False)
            x = torch.cat([feats[lvl], self._deconv(f"{net}.deconv{lvl}", x), up], dim=1)
            head = self._conv(f"{net}.inter_conv{lvl}", x, relu=False) if inter else x
            flow = self._conv(f"{net}.predict_flow{lvl}", head, relu=False)
        return flow.float()

    # -- the five networks ------------------------------------------------------

    def _flownetc(self, img0, n: int):
        """FlowNetC on the direction batch: img0 holds each direction's first
        image ([a; b]); its second is the other half of the same batch, so
        the towers run once and K7 reads b's maps at a batch shift of n."""
        net = "flownetc"
        x = self._conv(f"{net}.conv1", img0, 2)
        conv2 = self._conv(f"{net}.conv2", x, 2)
        conv3 = self._conv(f"{net}.conv3", conv2, 2)
        redir = self._conv(f"{net}.conv_redir", conv3)
        c_redir = redir.shape[1]
        cat = torch.empty((conv3.shape[0], c_redir + correlation_kernel.CHANNELS)
                          + tuple(conv3.shape[2:]), dtype=torch.float32, device=conv3.device)
        cat[:, :c_redir] = redir
        correlation_kernel.correlation(conv3, conv3, out=cat[:, c_redir:], b_shift=n)
        feats = self._down(net, cat, {2: conv2})
        return self._decoder(net, feats, inter=False)

    def _flownets(self, net, x):
        feats = self._encoder(net, x, (("conv1", 2), ("conv2", 2), ("conv3", 2)))
        return self._decoder(net, feats, inter=False)

    def _flownetsd(self, x):
        feats = self._encoder("flownets_d", x, (("conv0", 1), ("conv1", 2), ("conv1_1", 1),
                                                 ("conv2", 2), ("conv2_1", 1), ("conv3", 2)))
        return self._decoder("flownets_d", feats, inter=True)

    def _fusion(self, x):
        net = "flownetfusion"
        conv0 = self._conv(f"{net}.conv0", x)
        conv1 = self._conv(f"{net}.conv1_1", self._conv(f"{net}.conv1", conv0, 2))
        conv2 = self._conv(f"{net}.conv2_1", self._conv(f"{net}.conv2", conv1, 2))
        flow2 = self._conv(f"{net}.predict_flow2", conv2, relu=False)
        up = self._deconv(f"{net}.upsampled_flow2_to_1", flow2, relu=False)
        cat1 = torch.cat([conv1, self._deconv(f"{net}.deconv1", conv2), up], dim=1)
        flow1 = self._conv(f"{net}.predict_flow1",
                           self._conv(f"{net}.inter_conv1", cat1, relu=False), relu=False)
        up = self._deconv(f"{net}.upsampled_flow1_to_0", flow1, relu=False)
        cat0 = torch.cat([conv0, self._deconv(f"{net}.deconv0", cat1), up], dim=1)
        flow0 = self._conv(f"{net}.predict_flow0",
                           self._conv(f"{net}.inter_conv0", cat0, relu=False), relu=False)
        return flow0.float()

    def flows(self, a, b):
        """Both directions of N pairs: a, b (N, 3, H, W) float32 in [0, 1], H
        and W multiples of 64. Returns (2N, H, W, 2) float32 flows in pixels,
        a -> b for the first N, b -> a for the rest; ``_warp(b, a->b)``
        approximates a."""
        n = a.shape[0]
        mean = torch.cat([a, b], dim=2).mean(dim=(2, 3), keepdim=True)
        img0 = torch.cat([a - mean, b - mean])
        img1 = torch.cat([img0[n:], img0[:n]])
        x = torch.cat([img0, img1], dim=1)

        def stage_input(flow):
            warped = _warp(img1, flow)
            return torch.cat([x, warped, flow / DIV_FLOW, _norm(img0 - warped)], dim=1)

        with profiling.span("flow.fn2.c"):
            flow = _up4(self._flownetc(img0, n) * DIV_FLOW)
        with profiling.span("flow.fn2.s1"):
            flow = _up4(self._flownets("flownets_1", stage_input(flow)) * DIV_FLOW)
        with profiling.span("flow.fn2.s2"):
            flow_css = _up4(self._flownets("flownets_2", stage_input(flow)) * DIV_FLOW)
        with profiling.span("flow.fn2.sd"):
            flow_sd = _up4(self._flownetsd(x) / DIV_FLOW)
        with profiling.span("flow.fn2.fusion"):
            fused = self._fusion(torch.cat(
                [img0, flow_sd, flow_css, _norm(flow_sd), _norm(flow_css),
                 _norm(img0 - _warp(img1, flow_sd)), _norm(img0 - _warp(img1, flow_css))],
                dim=1))
        return fused.permute(0, 2, 3, 1)

    # -- FlowEstimator's interface --------------------------------------------

    @torch.no_grad()
    def prep(self, frame, flow_scale: float = 1.0):
        """One frame (H, W, 3) RGB uint8 or [0, 1] float at flow_scale
        resolution, edge-padded to a multiple of 64: (1, 3, H', W') float32."""
        return self.prep_batch(frame[None], flow_scale)

    @torch.no_grad()
    def prep_batch(self, frames, flow_scale: float = 1.0):
        """Batched :meth:`prep`: frames (N, H, W, 3) -> (N, 3, H', W')."""
        h, w = frames.shape[1], frames.shape[2]
        hs, ws = _scaled(h, w, flow_scale)
        hp, wp = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
        x = frames.to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        if (hs, ws) != (h, w):
            x = resize_bilinear(x, (hs, ws))
        return _pad_edge(x, hp, wp).permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def refine_pair(self, feats_a, feats_b, out_hw, flow_scale: float = 1.0,
                    with_lowres: bool = False, coarse_backward: bool = False,
                    fast_check: bool = False):
        """Both flow directions of a pair, as ``FlowEstimator.refine_pair``
        returns them: (flow_ab, flow_ba, maxabs_ab) at out_hw in
        full-resolution pixels, or with `with_lowres` (flow_ab_full,
        flow_ab_low, flow_ba_low, maxabs_low); maxabs a 0-d device tensor.
        coarse_backward and fast_check raise ValueError."""
        _pyramid_only(coarse_backward, fast_check)
        h, w = out_hw
        hs, ws = _scaled(h, w, flow_scale)
        both = self.flows(feats_a, feats_b)
        low_ab, low_ba = both[0, :hs, :ws], both[1, :hs, :ws]

        def up(flow):
            if (hs, ws) != (h, w):
                flow = resize_bilinear(flow, (h, w)) / flow_scale
            return flow

        maxabs = low_ab.abs().max()
        if with_lowres:
            return up(low_ab), low_ab, low_ba, maxabs
        return up(low_ab), up(low_ba), maxabs

    @torch.no_grad()
    def refine_pair_batch(self, feats_a, feats_b, out_hw, flow_scale: float = 1.0,
                          fast_check: bool = False):
        """Both directions of N pairs, as ``FlowEstimator.refine_pair_batch``
        returns them: (flow_ab_full (N, H, W, 2), flow_ab_low, flow_ba_low,
        maxabs_low over the batch). fast_check raises ValueError."""
        _pyramid_only(False, fast_check)
        h, w = out_hw
        hs, ws = _scaled(h, w, flow_scale)
        n = feats_a.shape[0]
        both = self.flows(feats_a, feats_b)
        low_ab, low_ba = both[:n, :hs, :ws], both[n:, :hs, :ws]
        full = low_ab
        if (hs, ws) != (h, w):
            full = resize_bilinear(low_ab, (h, w)) / flow_scale
        return full, low_ab, low_ba, low_ab.abs().max()
