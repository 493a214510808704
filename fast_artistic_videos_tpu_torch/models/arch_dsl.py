"""Arch-string DSL parser.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/models/arch_dsl.py`` (numpy and the standard
library only): the port imports nothing of the JAX package.

Grammar (reference: models_video.lua:55-140, documented README.md:255-261):
  cFsS-D   conv FxF, stride S, D output channels
  fFsS-D   full (transposed) conv FxF, stride S, output adjustment S-1
  dD       3x3 stride-2 downsampling conv, D channels
  uD       3x3 stride-2 learned upsampling (transposed conv, doubles H/W)
  UX       nearest-neighbor upsampling by factor X
  CD       non-residual conv block (two 3x3 convs, D channels)
  RD       residual block (two 3x3 convs + skip), D channels

Each layer except blocks and the final one is followed by a norm (instance or
batch) and ReLU; blocks carry their own norms ('C' keeps a trailing ReLU,
'R' has none); the network ends with tanh * tanh_constant.

Padding types (reference semantics, including its quirks):
  'zero'          — 'c' convs zero-pad (f-1)/2; blocks zero-pad 1.
  'reflect'       — explicit reflection pad before each conv.
  'replicate'     — explicit replication (edge) pad before each conv.
  'none'          — blocks run valid (shrinking); due to a reference bug
                    ('padding_type' read as an undeclared global at
                    models_video.lua:77) plain 'c' convs STILL zero-pad.
  'reflect-start' — like 'none' per layer, but the whole network is preceded
                    by one reflection pad sized so output == input (the
                    reference achieves this lazily at train_video.lua:319-325;
                    we compute it statically from the spec).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

VALID_PADDING_TYPES = ("zero", "reflect", "replicate", "none", "reflect-start")

# Named presets. 'video' models take 7 input channels (3 content + 3 warped
# prior + 1 certainty, models_video.lua:57); 'image' models take 3.
PRESETS = {
    # README.md:256 — the canonical pretrained-model architecture.
    "canonical": "c9s1-32,d64,d128,R128,R128,R128,R128,R128,U2,c3s1-64,U2,c9s1-3",
    # train_video.lua:21 default (learned upsampling).
    "train-default": "c9s1-32,d64,d128,R128,R128,R128,R128,R128,u64,u32,c9s1-3",
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                 # 'conv' | 'full_conv' | 'upsample' | 'conv_block' | 'res_block'
    out_channels: int = 0
    ksize: int = 3
    stride: int = 1
    scale: int = 1            # for 'upsample'
    pad: int = 0              # zero padding built into the conv
    pad_mode: Optional[str] = None  # explicit pre-pad: 'reflect' | 'replicate'
    out_adjust: int = 0       # transposed-conv output adjustment
    block_padding: Optional[str] = None  # padding type inside blocks
    norm_after: bool = False  # norm applied after this layer
    relu_after: bool = False


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    layers: Tuple[LayerSpec, ...]
    in_channels: int
    padding_type: str
    use_instance_norm: bool
    tanh_constant: float
    input_pad: int            # reflect-start pre-pad per side (input resolution)
    total_stride: int         # cumulative downsampling factor (for divisibility)

    @property
    def out_channels(self) -> int:
        return self.layers[-1].out_channels


_CONV_RE = re.compile(r"^([cf])(\d+)s(\d+)-(\d+)$")


def parse_arch(
    arch: str,
    in_channels: int = 7,
    padding_type: str = "reflect-start",
    use_instance_norm: bool = True,
    tanh_constant: float = 150.0,
) -> ModelSpec:
    if padding_type not in VALID_PADDING_TYPES:
        raise ValueError(f"unknown padding_type {padding_type!r}")
    arch = PRESETS.get(arch, arch)
    tokens = [t.strip() for t in arch.split(",") if t.strip()]
    if not tokens:
        raise ValueError(f"empty arch string: {arch!r}")

    layers: List[LayerSpec] = []
    shave_input_px = 0  # reflect-start: shrink per side measured at input res
    stride_product = 1
    valid_blocks = padding_type in ("none", "reflect-start")

    for i, tok in enumerate(tokens):
        last = i == len(tokens) - 1
        m = _CONV_RE.match(tok)
        if m:
            kind_ch, f, s, d = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
            p = (f - 1) // 2
            if kind_ch == "c":
                if padding_type in ("reflect", "replicate"):
                    layer = LayerSpec("conv", d, f, s, pad=0, pad_mode=padding_type)
                else:
                    # zero / none / reflect-start: conv zero-pads (f-1)/2
                    # (reference quirk, models_video.lua:69-79).
                    layer = LayerSpec("conv", d, f, s, pad=p)
                stride_product *= s
            else:
                layer = LayerSpec("full_conv", d, f, s, pad=p, out_adjust=s - 1)
                if s > 1:
                    if stride_product % s:
                        raise ValueError(f"upsample stride {s} does not divide {stride_product}")
                    stride_product //= s
        elif tok[0] == "d":
            layer = LayerSpec("conv", int(tok[1:]), 3, 2, pad=1)
            stride_product *= 2
        elif tok[0] == "u":
            layer = LayerSpec("full_conv", int(tok[1:]), 3, 2, pad=1, out_adjust=1)
            if stride_product % 2:
                raise ValueError("learned upsample at odd cumulative stride")
            stride_product //= 2
        elif tok[0] == "U":
            scale = int(tok[1:])
            layer = LayerSpec("upsample", 0, scale=scale)
            if stride_product % scale:
                raise ValueError(f"upsample x{scale} does not divide stride {stride_product}")
            stride_product //= scale
        elif tok[0] == "C":
            layer = LayerSpec("conv_block", int(tok[1:]), block_padding=padding_type)
            if valid_blocks:
                shave_input_px += 2 * stride_product
        elif tok[0] == "R":
            layer = LayerSpec("res_block", int(tok[1:]), block_padding=padding_type)
            if valid_blocks:
                shave_input_px += 2 * stride_product
        else:
            raise ValueError(f"unknown arch token {tok!r} in {arch!r}")

        if layer.kind == "upsample":
            prev = layers[-1].out_channels if layers else in_channels
            layer = dataclasses.replace(layer, out_channels=prev)

        needs_norm = layer.kind in ("conv", "full_conv", "upsample") and not last
        needs_relu = layer.kind in ("conv", "full_conv", "upsample", "conv_block") and not last
        layer = dataclasses.replace(layer, norm_after=needs_norm, relu_after=needs_relu)
        layers.append(layer)

    # total downsampling: recompute max intermediate stride for divisibility
    stride_run, max_stride = 1, 1
    for l in layers:
        if l.kind == "conv":
            stride_run *= l.stride
        elif l.kind == "full_conv":
            stride_run //= max(l.stride, 1)
        elif l.kind == "upsample":
            stride_run //= l.scale
        max_stride = max(max_stride, stride_run)

    input_pad = shave_input_px if padding_type == "reflect-start" else 0
    return ModelSpec(
        layers=tuple(layers),
        in_channels=in_channels,
        padding_type=padding_type,
        use_instance_norm=use_instance_norm,
        tanh_constant=tanh_constant,
        input_pad=input_pad,
        total_stride=max_stride,
    )
