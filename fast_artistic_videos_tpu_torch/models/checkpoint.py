"""Model checkpoint loading — counterpart of
``fast_artistic_videos_tpu/models/checkpoint.py``.

The checkpoint format is the JAX package's: one ``.npz`` with flattened
``layer/leaf`` parameters plus an ``__meta__`` JSON blob. Parameters stay
numpy until :func:`params_from_numpy` converts them to torch tensors, with
conv kernels moved from HWIO (JAX) to OIHW (PyTorch) once, at load time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core import device as device_mod
from .arch_dsl import LayerSpec, ModelSpec, parse_arch

ASSETS = os.path.join(os.path.dirname(__file__), "..", "..",
                      "fast_artistic_videos_tpu", "assets")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_model(path: str, params: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write a checkpoint in the JAX package's format from a numpy parameter
    tree in its layout (conv kernels HWIO; the t7 importer's output). meta
    must include: arch, in_channels, padding_type, use_instance_norm,
    tanh_constant; extra keys are kept."""
    flat = _flatten(params)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def params_from_numpy(tree: Dict[str, Any], device=device_mod.DEFAULT) -> Dict[str, Any]:
    """The JAX parameter tree (nested dicts of numpy arrays, or anything
    ``np.asarray`` accepts) -> the same tree of float32 torch tensors on
    `device` (the card unless ``device="cpu"``), with every 4-D conv kernel
    converted HWIO -> OIHW."""
    dev = device_mod.resolve(device)
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, dev)
            continue
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.array(a)).to(dev)
    return out


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: a tree of torch tensors ->
    float32 numpy arrays in the JAX package's layout (4-D conv kernels
    OIHW -> HWIO), as :func:`save_model` and the JAX package's
    ``load_model`` take them."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
            continue
        a = v.detach().float().cpu().numpy()
        out[k] = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return out


def load_model(path: str, device=device_mod.DEFAULT
               ) -> Tuple[ModelSpec, Dict[str, Any], Dict[str, Any]]:
    """Returns (spec, params, meta) with params as OIHW torch tensors on
    `device` (the card unless ``device="cpu"``). The literal string ``demo``
    resolves to the bundled demo checkpoint
    (``fast_artistic_videos_tpu/assets/demo-candy-video.npz``)."""
    if path == "demo":
        path = os.path.join(ASSETS, "demo-candy-video.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    params = params_from_numpy(_unflatten(flat), device)
    if "layers" in meta:
        # explicit layer list (t7-imported models have no arch string)
        layers = tuple(LayerSpec(**l) for l in meta["layers"])
        spec = ModelSpec(
            layers=layers,
            in_channels=int(meta.get("in_channels", 7)),
            padding_type=meta.get("padding_type", "reflect-start"),
            use_instance_norm=bool(meta.get("use_instance_norm", True)),
            tanh_constant=float(meta.get("tanh_constant", 150.0)),
            input_pad=int(meta.get("input_pad", 0)),
            total_stride=int(meta.get("total_stride", 1)),
        )
    else:
        spec = parse_arch(
            meta["arch"],
            in_channels=int(meta.get("in_channels", 7)),
            padding_type=meta.get("padding_type", "reflect-start"),
            use_instance_norm=bool(meta.get("use_instance_norm", True)),
            tanh_constant=float(meta.get("tanh_constant", 150.0)),
        )
    return spec, params, meta
