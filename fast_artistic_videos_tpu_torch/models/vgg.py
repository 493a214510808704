"""VGG-16 loss network as a pure feature extractor with taps — counterpart
of ``fast_artistic_videos_tpu/models/vgg.py``.

``extract_features(params, x, taps)`` returns the activations at the
requested *Torch sequential layer indices* (1-based), so the reference's
layer ids ("4,9,16,23" = relu1_2, relu2_2, relu3_3, relu4_3) address the
same tensors; the net runs only up to the deepest tap. Input is
VGG-preprocessed (BGR, x255, mean-subtracted) NHWC; inside, the convs are
NCHW ``F.conv2d`` (padding 1) in the input's dtype with TF32 off
(``core.device.float32_convs``), and the pools ``F.max_pool2d(2, 2)``.

Parameters are ``{"convNN": {"w": OIHW, "b": (Cout,)}}`` torch tensors, as
``models.checkpoint.params_from_numpy`` converts the JAX package's HWIO
tree; :func:`init_params` makes the same random law as the JAX version's.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import device as device_mod

# (torch_index, op, in_ch, out_ch); pools are 2x2/2 max pools.
# Full conv stack of VGG-16 (through conv5_3); linear head is never needed.
VGG16_LAYOUT: Tuple[Tuple[int, str, int, int], ...] = tuple(
    (i + 1, op, a, b)
    for i, (op, a, b) in enumerate(
        [
            ("conv", 3, 64), ("relu", 0, 0), ("conv", 64, 64), ("relu", 0, 0), ("pool", 0, 0),
            ("conv", 64, 128), ("relu", 0, 0), ("conv", 128, 128), ("relu", 0, 0), ("pool", 0, 0),
            ("conv", 128, 256), ("relu", 0, 0), ("conv", 256, 256), ("relu", 0, 0),
            ("conv", 256, 256), ("relu", 0, 0), ("pool", 0, 0),
            ("conv", 256, 512), ("relu", 0, 0), ("conv", 512, 512), ("relu", 0, 0),
            ("conv", 512, 512), ("relu", 0, 0), ("pool", 0, 0),
            ("conv", 512, 512), ("relu", 0, 0), ("conv", 512, 512), ("relu", 0, 0),
            ("conv", 512, 512), ("relu", 0, 0), ("pool", 0, 0),
        ]
    )
)


def init_params(generator: torch.Generator, device=device_mod.DEFAULT
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random VGG-16 weights drawn from `generator` on its device, uniform
    in (-stdv, stdv) with stdv = 1/sqrt(9 Cin) per layer (the JAX
    version's law; not its draws), as OIHW tensors on `device` (the card
    unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    params = {}
    for idx, op, cin, cout in VGG16_LAYOUT:
        if op != "conv":
            continue
        stdv = 1.0 / (3 * 3 * cin) ** 0.5
        w = torch.rand((cout, cin, 3, 3), generator=generator,
                       device=generator.device) * (2 * stdv) - stdv
        b = torch.rand((cout,), generator=generator, device=generator.device) * (2 * stdv) - stdv
        params[f"conv{idx:02d}"] = {"w": w.to(dev), "b": b.to(dev)}
    return params


def extract_features(params, x, taps: Sequence[int]):
    """x: (N, H, W, 3) VGG-preprocessed. Returns {tap_index: (N, h, w, c)}."""
    taps = tuple(int(t) for t in taps)
    deepest = max(taps)
    feats = {}
    y = x.permute(0, 3, 1, 2)
    with device_mod.float32_convs():
        for idx, op, _, _ in VGG16_LAYOUT:
            if op == "conv":
                p = params[f"conv{idx:02d}"]
                y = F.conv2d(y, p["w"].to(y.dtype), p["b"].to(y.dtype), padding=1)
            elif op == "relu":
                y = F.relu(y)
            elif op == "pool":
                y = F.max_pool2d(y, 2, 2)
            if idx in taps:
                feats[idx] = y.permute(0, 2, 3, 1)
            if idx >= deepest:
                break
    missing = set(taps) - set(feats)
    if missing:
        raise ValueError(f"invalid VGG tap indices: {sorted(missing)}")
    return feats
