"""The stylizer network in plain float32 PyTorch: the benchmark's reference.

A frozen copy of the arithmetic of the published video network
(``c9s1-32,d64,d128,R128x5,U2,c3s1-64,U2,c9s1-3``, fast-artistic-videos
``models_video.lua``) as the port's plain path computes it: reflect-start
padding (one reflection pad ahead of the net, sized so that the output is
as large as the input), zero-padded convs, VALID residual blocks, instance
norm with float32 ``E[x^2] - E[x]^2`` statistics and eps 1e-5, nearest
upsampling, ``tanh * 150``; and the rest of the architecture strings'
grammar: learned upsampling (``uD``, ``fFsS-D``: a transposed conv with the
output adjustment S - 1, its stored kernel pre-flipped) and non-residual
blocks (``CD``: two VALID 3x3 convs, each with its norm and a ReLU).
Activations are NHWC at the boundary, NCHW inside. It imports nothing of
the program; its parameters are the nested dict the benchmark draws (conv
kernels OIHW, ``layerNN`` names).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

import torch
import torch.nn.functional as F

TANH_CONSTANT = 150.0
EPS = 1e-5
VGG_MEAN_BGR = (103.939, 116.779, 123.68)


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str            # conv | full_conv | conv_block | res_block | upsample
    out_channels: int
    ksize: int = 3
    stride: int = 1
    pad: int = 0
    scale: int = 1
    out_adjust: int = 0  # a transposed conv's output adjustment
    norm_relu: bool = False
    relu: bool = False   # a ReLU alone after the layer (C blocks)


@dataclasses.dataclass(frozen=True)
class Net:
    layers: Tuple[Layer, ...]
    in_channels: int
    input_pad: int       # reflection pad per side ahead of the net
    total_stride: int    # frames are padded to a multiple of it


_CONV = re.compile(r"^([cf])(\d+)s(\d+)-(\d+)$")


def parse(arch: str, in_channels: int = 7) -> Net:
    """The architecture strings' tokens with reflect-start padding
    (``cFsS-D``, ``fFsS-D``, ``dD``, ``uD``, ``CD``, ``RD``, ``UX``); every
    layer but blocks and the last is followed by instance norm and ReLU, a
    C block but the last by a ReLU."""
    tokens = [t.strip() for t in arch.split(",") if t.strip()]
    layers: List[Layer] = []
    stride, shave, max_stride, ch = 1, 0, 1, in_channels
    for i, tok in enumerate(tokens):
        last = i == len(tokens) - 1
        m = _CONV.match(tok)
        if m and m.group(1) == "c":
            k, s, d = int(m.group(2)), int(m.group(3)), int(m.group(4))
            layer = Layer("conv", d, k, s, (k - 1) // 2, norm_relu=not last)
            stride *= s
        elif m:
            k, s, d = int(m.group(2)), int(m.group(3)), int(m.group(4))
            layer = Layer("full_conv", d, k, s, (k - 1) // 2, out_adjust=s - 1,
                          norm_relu=not last)
            stride //= s
        elif tok[0] == "d":
            layer = Layer("conv", int(tok[1:]), 3, 2, 1, norm_relu=not last)
            stride *= 2
        elif tok[0] == "u":
            layer = Layer("full_conv", int(tok[1:]), 3, 2, 1, out_adjust=1, norm_relu=not last)
            stride //= 2
        elif tok[0] == "C":
            layer = Layer("conv_block", int(tok[1:]), relu=not last)
            shave += 2 * stride
        elif tok[0] == "R":
            layer = Layer("res_block", int(tok[1:]))
            shave += 2 * stride
        elif tok[0] == "U":
            layer = Layer("upsample", ch, scale=int(tok[1:]), norm_relu=not last)
            stride //= layer.scale
        else:
            raise ValueError(f"token {tok!r} is outside the reference's architectures")
        ch = layer.out_channels
        max_stride = max(max_stride, stride)
        layers.append(layer)
    return Net(tuple(layers), in_channels, shave, max_stride)


def param_shapes(net: Net):
    """[(name, shape, law)] of every leaf in draw order; law is 'conv'
    (uniform in +-1/sqrt(fan_in)), 'unit' (uniform in [0, 1)) or 'zero'."""
    out = []
    ch = net.in_channels
    for i, layer in enumerate(net.layers):
        name = f"layer{i:02d}"
        if layer.kind in ("conv", "full_conv"):
            k = layer.ksize
            out += [(f"{name}/w", (layer.out_channels, ch, k, k), "conv"),
                    (f"{name}/b", (layer.out_channels,), "conv")]
            ch = layer.out_channels
        elif layer.kind in ("conv_block", "res_block"):
            d = layer.out_channels
            for c in ("1", "2"):
                out += [(f"{name}/conv{c}/w", (d, d, 3, 3), "conv"),
                        (f"{name}/conv{c}/b", (d,), "conv"),
                        (f"{name}/norm{c}/scale", (d,), "unit"),
                        (f"{name}/norm{c}/bias", (d,), "zero")]
            ch = d
        if layer.norm_relu:
            out += [(f"{name}_norm/scale", (ch,), "unit"),
                    (f"{name}_norm/bias", (ch,), "zero")]
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def instance_norm(x, scale, bias):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
    es = torch.rsqrt(var + EPS) * scale.view(1, -1, 1, 1)
    return x * es + (bias.view(1, -1, 1, 1) - mean * es)


def _conv(x, p, stride=1, pad=0):
    return F.conv2d(x, p["w"], p["b"], stride, pad)


def forward(params, net: Net, x):
    """x (N, H, W, in_channels) in VGG space, float32 -> (N, H, W, 3) in
    VGG space. Convs through cuDNN or the CPU in float32 (the caller turns
    TF32 off: :func:`float32`)."""
    h = F.pad(_nchw(x.float()), (net.input_pad,) * 4, mode="reflect")
    for i, layer in enumerate(net.layers):
        name = f"layer{i:02d}"
        if layer.kind == "conv":
            h = _conv(h, params[name], layer.stride, layer.pad)
        elif layer.kind == "full_conv":
            p = params[name]
            # the stored kernel is pre-flipped: flipped back, in and out swapped
            h = F.conv_transpose2d(h, p["w"].flip(2, 3).transpose(0, 1), None, layer.stride,
                                   layer.pad, layer.out_adjust) + p["b"].view(1, -1, 1, 1)
        elif layer.kind == "upsample":
            h = h.repeat_interleave(layer.scale, 2).repeat_interleave(layer.scale, 3)
        else:
            p = params[name]
            r = torch.relu(instance_norm(_conv(h, p["conv1"]), **p["norm1"]))
            r = instance_norm(_conv(r, p["conv2"]), **p["norm2"])
            h = r + h[:, :, 2:-2, 2:-2] if layer.kind == "res_block" else r
        if layer.norm_relu:
            h = torch.relu(instance_norm(h, **params[name + "_norm"]))
        if layer.relu:
            h = torch.relu(h)
    return _nhwc(torch.tanh(h) * TANH_CONSTANT)


def preprocess(rgb):
    """RGB [0, 1] (..., 3) -> VGG space (BGR * 255 - mean)."""
    mean = torch.tensor(VGG_MEAN_BGR, dtype=rgb.dtype, device=rgb.device)
    return rgb.flip(-1) * 255.0 - mean


def deprocess(vgg):
    mean = torch.tensor(VGG_MEAN_BGR, dtype=vgg.dtype, device=vgg.device)
    return ((vgg + mean) / 255.0).flip(-1)


def quantize(rgb):
    """[0, 1] float -> uint8, rounded and clipped."""
    return torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0).to(torch.uint8)


class float32:
    """Context: cuDNN convs and cuBLAS products in float32, TF32 off; the
    caller's flags come back on exit."""

    def __enter__(self):
        self._saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self._saved
        return False
