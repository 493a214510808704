"""The flow family ``flownet2``: FlowNet 2.0 in plain float32 PyTorch, the
benchmark's reference and the tests' (``reference/flow_pwclite.py`` lists
what a family gives). Imports nothing of the program.

Ilg, Mayer, Saikia, Keuper, Dosovitskiy, Brox, "FlowNet 2.0: Evolution of
Optical Flow Estimation with Deep Networks", CVPR 2017 (Caffe models:
github.com/lmb-freiburg/flownet2; the PyTorch layout and layer names:
github.com/NVIDIA/flownet2-pytorch, ``models.py`` ``FlowNet2`` and
``networks/FlowNetC.py``, ``FlowNetS.py``, ``FlowNetSD.py``,
``FlowNetFusion.py``), at the published widths: FlowNetC (with its
441-channel correlation of displacements up to 20 in steps of 2), two
FlowNetS, FlowNetSD and the fusion net, 162.5 M parameters.

One direction a call (``pair``), every layer recomputed, the correlation a
plain loop over its 441 shifts. The conventions the sources leave to the
framework, shared with the program: the pair's per-channel mean over both
padded frames; the x4 flow upsample bilinear with ``align_corners=False``;
the warps a bilinear gather whose taps outside the image read zero
(flownet2-pytorch's ``Resample2d`` not confirmed offline); the SD flow
divided by div_flow where the other stages' are multiplied; the frame
edge-padded to a multiple of 64 where the Caffe deploy net resizes it.

Weights from the seed (``draw``): every kernel and bias uniform in
+-1/sqrt(fan_in), fan_in = input channels x kernel area (also for a
transposed conv), from one ``torch.rand`` call on a generator of the
family's own stream. The flow upsamplers of C, S and SD have no bias; the
fusion's have one (flownet2-pytorch's ``FlowNetFusion``). The checkpoint
(``save`` / ``load``) holds ``name/leaf`` keys, every 4-D kernel as the
PyTorch tensor transposed by (2, 3, 1, 0): a conv's OIHW as HWIO, a
transposed conv's (Cin, Cout, kh, kw) as (kh, kw, Cout, Cin).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import flow
from portbench.reference import stylizer as net_ref

STRIDE = 64
DIV_FLOW = 20.0
MAX_DISPLACEMENT = 20
DISPLACEMENT_STRIDE = 2
GRID = 2 * MAX_DISPLACEMENT // DISPLACEMENT_STRIDE + 1
scaled = flow.scaled

# (name, k, stride, cin, cout) of the encoders after conv3 (C and S)
_DOWN = (("conv3_1", 3, 1, 256, 256), ("conv4", 3, 2, 256, 512), ("conv4_1", 3, 1, 512, 512),
         ("conv5", 3, 2, 512, 512), ("conv5_1", 3, 1, 512, 512), ("conv6", 3, 2, 512, 1024),
         ("conv6_1", 3, 1, 1024, 1024))
_SD = (("conv0", 3, 1, 6, 64), ("conv1", 3, 2, 64, 64), ("conv1_1", 3, 1, 64, 128),
       ("conv2", 3, 2, 128, 128), ("conv2_1", 3, 1, 128, 128), ("conv3", 3, 2, 128, 256))
_FUSION = (("conv0", 3, 1, 11, 64), ("conv1", 3, 2, 64, 64), ("conv1_1", 3, 1, 64, 128),
           ("conv2", 3, 2, 128, 128), ("conv2_1", 3, 1, 128, 128))


def _decoder(inter: bool):
    """[(name, kind, k, cin, cout)] of a C / S / SD decoder, levels 6 to 2."""
    out = [("predict_flow6", "conv", 3, 1024, 2)]
    cin, enc = 1024, {5: 512, 4: 512, 3: 256, 2: 128}
    width = {5: 512, 4: 256, 3: 128, 2: 64}
    for lvl in (5, 4, 3, 2):
        out.append((f"deconv{lvl}", "deconv", 4, cin, width[lvl]))
        out.append((f"upsampled_flow{lvl + 1}_to_{lvl}", "up", 4, 2, 2))
        cat = enc[lvl] + width[lvl] + 2
        if inter:
            out.append((f"inter_conv{lvl}", "conv", 3, cat, width[lvl]))
            out.append((f"predict_flow{lvl}", "conv", 3, width[lvl], 2))
        else:
            out.append((f"predict_flow{lvl}", "conv", 3, cat, 2))
        cin = cat
    return out


def layers():
    """[(name, kind, k, cin, cout)] of every layer, in draw order; kind
    "conv" (OIHW kernel, bias), "deconv" ((Cin, Cout, 4, 4), bias; also the
    fusion's flow upsamplers) or "up" ((2, 2, 4, 4), no bias: C's, S's and
    SD's flow upsamplers)."""
    out = []
    c = [("conv1", 7, 2, 3, 64), ("conv2", 5, 2, 64, 128), ("conv3", 5, 2, 128, 256),
         ("conv_redir", 1, 1, 256, 32), ("conv3_1", 3, 1, 32 + GRID * GRID, 256)] + list(_DOWN[1:])
    out += [(f"flownetc.{n}", "conv", k, ci, co) for n, k, _, ci, co in c]
    out += [(f"flownetc.{n}", *rest) for n, *rest in _decoder(False)]
    for net in ("flownets_1", "flownets_2"):
        s = [("conv1", 7, 2, 12, 64), ("conv2", 5, 2, 64, 128), ("conv3", 5, 2, 128, 256)]
        out += [(f"{net}.{n}", "conv", k, ci, co) for n, k, _, ci, co in s + list(_DOWN)]
        out += [(f"{net}.{n}", *rest) for n, *rest in _decoder(False)]
    out += [(f"flownets_d.{n}", "conv", k, ci, co) for n, k, _, ci, co in _SD + _DOWN]
    out += [(f"flownets_d.{n}", *rest) for n, *rest in _decoder(True)]
    f = "flownetfusion"
    out += [(f"{f}.{n}", "conv", k, ci, co) for n, k, _, ci, co in _FUSION]
    out += [(f"{f}.predict_flow2", "conv", 3, 128, 2),
            (f"{f}.deconv1", "deconv", 4, 128, 32), (f"{f}.upsampled_flow2_to_1", "deconv", 4, 2, 2),
            (f"{f}.inter_conv1", "conv", 3, 162, 32), (f"{f}.predict_flow1", "conv", 3, 32, 2),
            (f"{f}.deconv0", "deconv", 4, 162, 16), (f"{f}.upsampled_flow1_to_0", "deconv", 4, 2, 2),
            (f"{f}.inter_conv0", "conv", 3, 82, 16), (f"{f}.predict_flow0", "conv", 3, 16, 2)]
    return out


def _shape(kind, k, cin, cout):
    return (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)


def draw(seed: int, device) -> dict:
    """Every kernel and bias uniform in +-1/sqrt(cin k k), from one
    ``torch.rand`` call on a generator of the family's own stream."""
    specs = layers()
    sizes = [(int(np.prod(_shape(kind, k, ci, co))), 0 if kind == "up" else co)
             for _, kind, k, ci, co in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 0xF12]).generate_state(
        1, np.uint64)[0]) % (2 ** 63))
    flat = torch.rand(sum(a + b for a, b in sizes), generator=gen, device=device)
    flat.mul_(2).sub_(1)
    tree, at = {}, 0
    for (name, kind, k, ci, co), (nw, nb) in zip(specs, sizes):
        stdv = 1.0 / float(ci * k * k) ** 0.5
        leaves = {"w": flat[at:at + nw].view(_shape(kind, k, ci, co)).mul_(stdv)}
        if nb:
            leaves["b"] = flat[at + nw:at + nw + nb].mul_(stdv)
        at += nw + nb
        tree[name] = leaves
    return tree


def load(path: str, device) -> dict:
    """The tree from the npz: 4-D kernels transposed (3, 2, 0, 1) back."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            name, leaf = key.rsplit("/", 1)
            a = np.asarray(z[key], np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            tree.setdefault(name, {})[leaf] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tree


def save(path: str, params: dict) -> None:
    """The npz the program reads (``flow.estimator.load_params``)."""
    arrays = {}
    for name, leaves in params.items():
        for leaf, t in leaves.items():
            a = t.detach().float().cpu().numpy()
            arrays[f"{name}/{leaf}"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def features(params, frames_u8, scale: float):
    """(N, 3, H', W') float32 [0, 1]: (N, H, W, 3) uint8 frames resized to
    `scale` and edge-padded to a multiple of 64 (the pair's mean depends on
    both frames, so nothing more of a frame is reused)."""
    n, h, w = frames_u8.shape[:3]
    hs, ws = scaled(h, w, scale)
    x = frames_u8.float() / 255.0
    if (hs, ws) != (h, w):
        x = flow.resize_bilinear(x, (hs, ws))
    hp, wp = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
    rows = torch.arange(hp, device=x.device).clamp(max=hs - 1)
    cols = torch.arange(wp, device=x.device).clamp(max=ws - 1)
    return x[:, rows][:, :, cols].permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _conv(params, name, x, stride=1, relu=True):
    p = params[name]
    y = F.conv2d(x, p["w"], p["b"], stride, (p["w"].shape[-1] - 1) // 2)
    return F.leaky_relu(y, 0.1) if relu else y


def _deconv(params, name, x, relu=True):
    p = params[name]
    y = F.conv_transpose2d(x, p["w"], p.get("b"), 2, 1)
    return F.leaky_relu(y, 0.1) if relu else y


def correlation(f1, f2):
    """FlowNetC's correlation and its LeakyReLU: (N, 441, H, W), one
    product and channel sum a shift, b reading zero outside the map."""
    n, c, h, w = f1.shape
    d = MAX_DISPLACEMENT
    f2p = F.pad(f2, (d, d, d, d))
    rows = []
    for i in range(GRID):
        for j in range(GRID):
            dy, dx = DISPLACEMENT_STRIDE * i, DISPLACEMENT_STRIDE * j
            rows.append((f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1) / c)
    return F.leaky_relu(torch.stack(rows, dim=1), 0.1)


def warp(img, flw):
    """img (N, C, H, W) sampled at (x + dx, y + dy) bilinearly, each of
    the four taps reading zero outside the image."""
    n, c, h, w = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w)
    xf, yf = xs + flw[:, 0], ys + flw[:, 1]
    x0, y0 = torch.floor(xf), torch.floor(yf)
    fx, fy = xf - x0, yf - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(n, c, h * w)
    out = torch.zeros_like(img)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).view(n, 1, h * w)
            tap = torch.gather(flat, 2, idx.expand(n, c, h * w)).view(n, c, h, w)
            out = out + tap * (wy * wx * ok)[:, None]
    return out


def _norm(x):
    return torch.sqrt((x * x).sum(dim=1, keepdim=True))


def _up4(flw):
    return F.interpolate(flw, scale_factor=4, mode="bilinear", align_corners=False)


def _decode(params, net, feats, inter):
    x = feats[6]
    flw = _conv(params, f"{net}.predict_flow6", x, relu=False)
    for lvl in (5, 4, 3, 2):
        up = _deconv(params, f"{net}.upsampled_flow{lvl + 1}_to_{lvl}", flw, relu=False)
        x = torch.cat([feats[lvl], _deconv(params, f"{net}.deconv{lvl}", x), up], dim=1)
        head = _conv(params, f"{net}.inter_conv{lvl}", x, relu=False) if inter else x
        flw = _conv(params, f"{net}.predict_flow{lvl}", head, relu=False)
    return flw


def _encode_down(params, net, x, feats):
    for name, _, stride, _, _ in _DOWN:
        x = _conv(params, f"{net}.{name}", x, stride)
        if name in ("conv3_1", "conv4_1", "conv5_1", "conv6_1"):
            feats[int(name[4])] = x
    return feats


def flownetc(params, a, b):
    net = "flownetc"
    ta, tb = [], []
    for img, t in ((a, ta), (b, tb)):
        x = img
        for name, k, stride in (("conv1", 7, 2), ("conv2", 5, 2), ("conv3", 5, 2)):
            x = _conv(params, f"{net}.{name}", x, stride)
            t.append(x)
    x = torch.cat([_conv(params, f"{net}.conv_redir", ta[2]), correlation(ta[2], tb[2])], dim=1)
    return _decode(params, net, _encode_down(params, net, x, {2: ta[1]}), False)


def flownets(params, net, x):
    for name, stride in (("conv1", 2), ("conv2", 2), ("conv3", 2)):
        x = _conv(params, f"{net}.{name}", x, stride)
        if name == "conv2":
            conv2 = x
    return _decode(params, net, _encode_down(params, net, x, {2: conv2}), False)


def flownetsd(params, x):
    net = "flownets_d"
    for name, _, stride, _, _ in _SD:
        x = _conv(params, f"{net}.{name}", x, stride)
        if name == "conv2_1":
            conv2 = x
    return _decode(params, net, _encode_down(params, net, x, {2: conv2}), True)


def fusion(params, x):
    f = "flownetfusion"
    conv0 = _conv(params, f"{f}.conv0", x)
    conv1 = _conv(params, f"{f}.conv1_1", _conv(params, f"{f}.conv1", conv0, 2))
    conv2 = _conv(params, f"{f}.conv2_1", _conv(params, f"{f}.conv2", conv1, 2))
    flow2 = _conv(params, f"{f}.predict_flow2", conv2, relu=False)
    cat1 = torch.cat([conv1, _deconv(params, f"{f}.deconv1", conv2),
                      _deconv(params, f"{f}.upsampled_flow2_to_1", flow2, relu=False)], dim=1)
    flow1 = _conv(params, f"{f}.predict_flow1",
                  _conv(params, f"{f}.inter_conv1", cat1, relu=False), relu=False)
    cat0 = torch.cat([conv0, _deconv(params, f"{f}.deconv0", cat1),
                      _deconv(params, f"{f}.upsampled_flow1_to_0", flow1, relu=False)], dim=1)
    return _conv(params, f"{f}.predict_flow0",
                 _conv(params, f"{f}.inter_conv0", cat0, relu=False), relu=False)


def pair(params, feats_a, feats_b):
    """The flow a -> b (N, H', W', 2) at the padded flow resolution, in its
    pixels: FlowNet 2.0 on the pair (a, b); warping b by it approximates a.
    cuDNN's convs and cuBLAS's products in float32, TF32 off."""
    with net_ref.float32():
        return _pair(params, feats_a, feats_b)


def _pair(params, feats_a, feats_b):
    n = feats_a.shape[0]
    mean = torch.stack([feats_a, feats_b], dim=2).reshape(n, 3, -1).mean(dim=-1)
    mean = mean.view(n, 3, 1, 1)
    a, b = feats_a - mean, feats_b - mean
    x = torch.cat([a, b], dim=1)

    def stage_input(flw):
        warped = warp(b, flw)
        return torch.cat([x, warped, flw / DIV_FLOW, _norm(a - warped)], dim=1)

    flw = _up4(flownetc(params, a, b) * DIV_FLOW)
    flw = _up4(flownets(params, "flownets_1", stage_input(flw)) * DIV_FLOW)
    css = _up4(flownets(params, "flownets_2", stage_input(flw)) * DIV_FLOW)
    sd = _up4(flownetsd(params, x) / DIV_FLOW)
    fused = fusion(params, torch.cat([a, sd, css, _norm(sd), _norm(css),
                                      _norm(a - warp(b, sd)), _norm(a - warp(b, css))], dim=1))
    return fused.permute(0, 2, 3, 1)


def flops(params_like, frame_hw, n: int, scale: float) -> int:
    """Operations of n new frames, both directions of each pair, every
    layer of each direction: the convs by FlopCounterMode on meta tensors,
    the correlation's multiply-adds (441 x C x H x W a direction, not an
    op the counter counts) added."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = frame_hw
    hs, ws = scaled(h, w, scale)
    fh, fw = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
    fp = {k: {leaf: torch.empty(t.shape, device="meta") for leaf, t in v.items()}
          for k, v in params_like.items()}
    feats = torch.empty((n, 3, fh, fw), device="meta")
    with FlopCounterMode(display=False) as fc:
        pair(fp, feats, feats)
        pair(fp, feats, feats)
    c3 = params_like["flownetc.conv3"]["w"].shape[0]
    corr = 2 * GRID * GRID * c3 * n * (fh // 8) * (fw // 8)
    return int(fc.get_total_flops()) + 2 * corr
