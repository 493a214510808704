"""The stylizer's weights, drawn from the seed on the card, and the
checkpoint the program loads them from.

One ``torch.rand`` call on a generator on the device fills every leaf at
once; each leaf takes the reference's law (``reference.stylizer.
param_shapes``): conv kernels and biases uniform in +-1/sqrt(fan_in),
instance-norm scales uniform in [0, 1), norm biases zero. The tree (conv
kernels OIHW) goes to the reference as it is; the program reads it from
a checkpoint in its own format (HWIO kernels, an ``__meta__`` record),
written with the program's ``models.checkpoint.save_model``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import stylizer as net_ref


def draw(net: net_ref.Net, seed: int, device) -> dict:
    shapes = net_ref.param_shapes(net)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(total, generator=gen, device=device)
    tree: dict = {}
    at = 0
    for name, shape, law in shapes:
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        at += n
        if law == "conv":
            leaf = leaf * 2 - 1
        elif law == "zero":
            leaf = torch.zeros_like(leaf)
        tree_set(tree, name, leaf)
    _scale_convs(tree)
    return tree


def tree_set(tree: dict, path: str, leaf):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _scale_convs(node: dict):
    if "w" in node and "b" in node and node["w"].ndim == 4:
        stdv = 1.0 / float(np.prod(node["w"].shape[1:])) ** 0.5
        node["w"] = (node["w"] * stdv).contiguous()
        node["b"] = (node["b"] * stdv).contiguous()
        return
    for v in node.values():
        if isinstance(v, dict):
            _scale_convs(v)


def to_numpy_hwio(tree: dict) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_numpy_hwio(v)
        else:
            a = v.detach().float().cpu().numpy()
            out[k] = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return out


def write_checkpoint(path: str, tree: dict, cfg: dict) -> None:
    from fast_artistic_videos_tpu_torch.models import checkpoint

    meta = {"arch": cfg["arch"], "in_channels": int(cfg["in_channels"]),
            "padding_type": cfg["padding_type"],
            "use_instance_norm": bool(cfg["use_instance_norm"]),
            "tanh_constant": float(cfg["tanh_constant"])}
    checkpoint.save_model(path, to_numpy_hwio(tree), meta)
