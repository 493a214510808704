"""Torch7 ``.t7`` serialization: reader, writer, and checkpoint converters.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/models/t7.py``:
the reader, the writer and the converters are numpy; ``import_stylizer``
returns the port's parameters (OIHW torch tensors on a device, through
``models.checkpoint.params_from_numpy``), and ``convert_model_file`` writes
the JAX package's checkpoint format from the numpy tree.

The reference ships pretrained models as Torch7 binary checkpoints
({model=nn.Sequential, opt=...} tables, train_video.lua:523-541) and the
VGG-16 loss network as ``vgg16.t7``. This module reads that format and
converts the nn module graphs into this framework's (spec, params) form.

Format (Torch7 binary, little-endian):
  record   := int32 type, payload
  type 0   nil
  type 1   number (f64)
  type 2   string (int32 len, bytes)
  type 3   table: int32 heap-index, int32 count, count * (key, value) records
  type 4   torch object: int32 heap-index, version string ("V <n>" or the
           legacy class name itself), class name string, then the class
           payload (tensors/storages have native payloads; nn modules store
           their instance-variable table as a record)
  type 5   boolean (int32)
  type 6   function: int32 len dump + upvalue table — skipped
  type 7/8 recursive function: int32 heap-index, then as type 6 — skipped
  tensors  := int32 ndim, int64[ndim] size, int64[ndim] stride,
              int64 storage_offset (1-based), storage record
  storages := int64 count, raw elements

Heap-indexed records (tables/objects) appearing again are back-references.

The writer emits the same format (used to build test fixtures and to export
checkpoints back to Torch-compatible files).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import device as device_mod
from . import checkpoint as model_ckpt
from .arch_dsl import LayerSpec, ModelSpec

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64,
    "torch.FloatTensor": np.float32,
    "torch.HalfTensor": np.float16,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
    "torch.CudaTensor": np.float32,
}
_STORAGE_DTYPES = {k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()}


class TorchObject:
    """A deserialized torch class instance (e.g. an nn module)."""

    def __init__(self, torch_typename: str, attrs: Optional[dict] = None):
        self.torch_typename = torch_typename
        self.attrs = attrs or {}

    def __getitem__(self, key):
        return self.attrs.get(key)

    def get(self, key, default=None):
        return self.attrs.get(key, default)

    def __repr__(self):
        return f"TorchObject({self.torch_typename})"


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.memo: Dict[int, Any] = {}

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated t7 file")
        self.pos += n
        return b

    def read_int(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def read_long(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def read_string(self) -> str:
        n = self.read_int()
        return self._take(n).decode("utf-8", errors="replace")

    def read_array(self, n: int, dtype) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        return np.frombuffer(self._take(n * itemsize), dtype=dtype).copy()

    def read_object(self) -> Any:
        typ = self.read_int()
        if typ == TYPE_NIL:
            return None
        if typ == TYPE_NUMBER:
            v = self.read_double()
            return int(v) if v.is_integer() and abs(v) < 2**53 else v
        if typ == TYPE_STRING:
            return self.read_string()
        if typ == TYPE_BOOLEAN:
            return self.read_int() == 1
        if typ == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            out: Dict[Any, Any] = {}
            self.memo[idx] = out
            count = self.read_int()
            for _ in range(count):
                k = self.read_object()
                out[k] = self.read_object()
            return out
        if typ == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            version = self.read_string()
            if version.startswith("V "):
                cls = self.read_string()
            else:
                cls = version  # legacy: the version string is the class name
            return self._read_torch_payload(idx, cls)
        if typ == TYPE_FUNCTION:
            # no heap index (torch7 File.lua TYPE_FUNCTION branch)
            size = self.read_int()
            self._take(size)
            self.read_object()  # upvalues
            return None
        if typ in (TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            # unlike TYPE_FUNCTION these carry a heap index before the dump
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            self.memo[idx] = None
            size = self.read_int()
            self._take(size)
            self.read_object()  # upvalues
            return None
        raise ValueError(f"unknown t7 record type {typ}")

    def _read_torch_payload(self, idx: int, cls: str) -> Any:
        if cls in _TENSOR_DTYPES:
            ndim = self.read_int()
            size = self.read_array(ndim, np.int64)
            stride = self.read_array(ndim, np.int64)
            offset = self.read_long() - 1
            placeholder = TorchObject(cls)
            self.memo[idx] = placeholder
            storage = self.read_object()
            if storage is None or ndim == 0:
                arr = np.zeros([int(s) for s in size], _TENSOR_DTYPES[cls])
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=[int(s) for s in size],
                    strides=[int(s) * storage.dtype.itemsize for s in stride],
                ).copy()
            self.memo[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            n = self.read_long()
            arr = self.read_array(n, _STORAGE_DTYPES[cls])
            self.memo[idx] = arr
            return arr
        obj = TorchObject(cls)
        self.memo[idx] = obj
        payload = self.read_object()
        obj.attrs = payload if isinstance(payload, dict) else {"_payload": payload}
        return obj


def load_t7(path: str) -> Any:
    with open(path, "rb") as f:
        return _Reader(f.read()).read_object()


# ---------------------------------------------------------------------------
# writer (test fixtures / export)
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.chunks: List[bytes] = []
        self.memo: Dict[int, int] = {}
        self.next_index = 1

    def w(self, b: bytes):
        self.chunks.append(b)

    def write_int(self, v: int):
        self.w(struct.pack("<i", v))

    def write_string(self, s: str):
        b = s.encode()
        self.write_int(len(b))
        self.w(b)

    def write_object(self, obj: Any):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.w(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, dict):
            self.write_int(TYPE_TABLE)
            key = id(obj)
            if key in self.memo:
                self.write_int(self.memo[key])
                return
            self.memo[key] = self.next_index
            self.write_int(self.next_index)
            self.next_index += 1
            self.write_int(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, list):
            # lua array-style table (1-based integer keys)
            self.write_object({i + 1: v for i, v in enumerate(obj)})
        elif isinstance(obj, TorchObject):
            self.write_int(TYPE_TORCH)
            key = id(obj)
            if key in self.memo:
                self.write_int(self.memo[key])
                return
            self.memo[key] = self.next_index
            self.write_int(self.next_index)
            self.next_index += 1
            self.write_string("V 1")
            self.write_string(obj.torch_typename)
            self.write_object(obj.attrs)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _write_tensor(self, arr: np.ndarray):
        if arr.dtype == np.float64:
            cls = "torch.DoubleTensor"
        elif arr.dtype == np.float32:
            cls = "torch.FloatTensor"
        elif arr.dtype == np.int64:
            cls = "torch.LongTensor"
        elif arr.dtype == np.uint8:
            cls = "torch.ByteTensor"
        else:
            arr = arr.astype(np.float32)
            cls = "torch.FloatTensor"
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_index)
        tensor_idx = self.next_index
        self.next_index += 1
        self.write_string("V 1")
        self.write_string(cls)
        arr = np.ascontiguousarray(arr)
        self.write_int(arr.ndim)
        self.w(np.asarray(arr.shape, np.int64).tobytes())
        strides = [int(s // arr.dtype.itemsize) for s in arr.strides]
        self.w(np.asarray(strides, np.int64).tobytes())
        self.w(struct.pack("<q", 1))  # storage offset (1-based)
        # storage record
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_index)
        self.next_index += 1
        self.write_string("V 1")
        self.write_string(cls.replace("Tensor", "Storage"))
        self.w(struct.pack("<q", arr.size))
        self.w(arr.tobytes())
        del tensor_idx


def save_t7(path: str, obj: Any) -> None:
    w = _Writer()
    w.write_object(obj)
    with open(path, "wb") as f:
        f.write(b"".join(w.chunks))


# ---------------------------------------------------------------------------
# nn graph -> (ModelSpec, params) conversion
# ---------------------------------------------------------------------------

def _as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _modules(seq: TorchObject) -> List[TorchObject]:
    mods = seq["modules"]
    if isinstance(mods, dict):
        return [mods[k] for k in sorted(k for k in mods if isinstance(k, int))]
    return list(mods or [])


def _conv_params(m: TorchObject) -> Dict[str, np.ndarray]:
    w = _as_f32(m["weight"])
    if w.ndim == 2:  # flattened (O, I*kH*kW)
        w = w.reshape(m["nOutputPlane"], m["nInputPlane"], m["kH"], m["kW"])
    return {"w": np.transpose(w, (2, 3, 1, 0)).copy(), "b": _as_f32(m["bias"])}


def _full_conv_params(m: TorchObject) -> Dict[str, np.ndarray]:
    w = _as_f32(m["weight"])  # (I, O, kH, kW)
    w = w[:, :, ::-1, ::-1]   # our conv_transpose2d stores spatially flipped
    return {"w": np.transpose(w, (2, 3, 0, 1)).copy(), "b": _as_f32(m["bias"])}


def _norm_params(m: TorchObject) -> Dict[str, np.ndarray]:
    out = {"scale": _as_f32(m["weight"]), "bias": _as_f32(m["bias"])}
    if m.torch_typename == "nn.SpatialBatchNormalization" and m["running_mean"] is not None:
        out["running_mean"] = _as_f32(m["running_mean"])
        out["running_var"] = _as_f32(m["running_var"])
    return out


def import_stylizer(checkpoint: Any, device=device_mod.DEFAULT):
    """Convert a reference stylizer checkpoint ({model=...} or a bare
    nn.Sequential) into (ModelSpec, params), the params as the port's OIHW
    torch tensors on `device` (the card unless ``device="cpu"``)."""
    spec, params = import_stylizer_numpy(checkpoint)
    return spec, model_ckpt.params_from_numpy(params, device)


def import_stylizer_numpy(checkpoint: Any):
    """:func:`import_stylizer` with the params as the JAX package's numpy
    tree (conv kernels HWIO), the checkpoint file's layout.

    Reconstructs the arch by pattern-matching the module sequence the
    reference builder emits (models_video.lua:55-140): conv/full-conv
    layers with optional norm+ReLU, residual/conv blocks, nearest
    upsampling, a possible leading reflection pad (the reflect-start fixup,
    train_video.lua:319-325), and the tanh * constant tail.
    """
    model = checkpoint
    if isinstance(checkpoint, dict) and "model" in checkpoint:
        model = checkpoint["model"]
    elif isinstance(checkpoint, TorchObject) and checkpoint.get("model") is not None:
        model = checkpoint["model"]
    mods = _modules(model)
    params: Dict[str, Any] = {}
    layers: List[LayerSpec] = []
    input_pad = 0
    tanh_constant = 150.0
    use_in = True
    in_channels = None
    i = 0
    layer_idx = 0

    def peek(j):
        return mods[j].torch_typename if j < len(mods) else None

    if mods and peek(0) == "nn.SpatialReflectionPadding":
        input_pad = int(mods[0]["pad_l"])
        i = 1

    while i < len(mods):
        t = peek(i)
        # cudnn module names appear if a checkpoint was saved without the
        # cudnn->nn conversion (the reference converts before saving,
        # train_video.lua:528-531, but be liberal in what we accept)
        if t and t.startswith("cudnn."):
            mods[i].torch_typename = t = t.replace("cudnn.", "nn.")
        name = f"layer{layer_idx:02d}"
        consumed_norm_relu = False
        if t == "nn.SpatialConvolution":
            m = mods[i]
            if in_channels is None:
                in_channels = int(m["nInputPlane"])
            p = _conv_params(m)
            params[name] = p
            layers.append(LayerSpec(
                "conv", int(m["nOutputPlane"]), int(m["kH"]), int(m["dH"]),
                pad=int(m["padH"] or 0),
            ))
            i += 1
        elif t == "nn.SpatialFullConvolution":
            m = mods[i]
            if in_channels is None:
                in_channels = int(m["nInputPlane"])
            params[name] = _full_conv_params(m)
            layers.append(LayerSpec(
                "full_conv", int(m["nOutputPlane"]), int(m["kH"]), int(m["dH"]),
                pad=int(m["padH"] or 0), out_adjust=int(m.get("adjH") or 0),
            ))
            i += 1
        elif t == "nn.SpatialUpSamplingNearest":
            layers.append(LayerSpec("upsample", layers[-1].out_channels if layers else 0,
                                    scale=int(mods[i]["scale_factor"])))
            i += 1
        elif t == "nn.Sequential":
            # residual block: Sequential(ConcatTable(block, shave/id), CAddTable)
            inner = _modules(mods[i])
            if inner and inner[0].torch_typename == "nn.ConcatTable":
                branches = _modules(inner[0])
                block_mods = _modules(branches[0])
                skip = branches[1].torch_typename
                bp, dim = _convert_block(block_mods)
                params[name] = bp
                layers.append(LayerSpec(
                    "res_block", dim,
                    block_padding="none" if skip == "nn.ShaveImage" else "zero",
                ))
                i += 1
            else:
                bp, dim = _convert_block(inner)
                params[name] = bp
                layers.append(LayerSpec("conv_block", dim, block_padding="zero"))
                i += 1
        elif t == "nn.Tanh":
            i += 1
            if peek(i) == "nn.MulConstant":
                tanh_constant = float(mods[i]["constant_scalar"])
                i += 1
            while i < len(mods) and peek(i) in ("nn.TotalVariation",):
                i += 1
            continue
        elif t in ("nn.ReLU", "nn.TotalVariation", "nn.MulConstant"):
            i += 1
            continue
        else:
            raise ValueError(f"unsupported module in checkpoint: {t}")

        # optional norm / relu following the layer
        if peek(i) == "nn.InstanceNormalization":
            params[name + "_norm"] = _norm_params(mods[i])
            layers[-1] = dataclass_replace(layers[-1], norm_after=True)
            i += 1
        elif peek(i) == "nn.SpatialBatchNormalization":
            use_in = False
            params[name + "_norm"] = _norm_params(mods[i])
            layers[-1] = dataclass_replace(layers[-1], norm_after=True)
            i += 1
        if peek(i) == "nn.ReLU":
            layers[-1] = dataclass_replace(layers[-1], relu_after=True)
            i += 1
        del consumed_norm_relu
        layer_idx += 1

    # padding type: a leading reflection pad means reflect-start; otherwise
    # res-block skip type decides
    if input_pad:
        padding_type = "reflect-start"
    elif any(l.kind == "res_block" and l.block_padding == "none" for l in layers):
        padding_type = "none"
    else:
        padding_type = "zero"
    layers = [
        dataclass_replace(l, block_padding=padding_type)
        if l.kind in ("res_block", "conv_block") else l
        for l in layers
    ]
    spec = ModelSpec(
        layers=tuple(layers),
        in_channels=in_channels or 3,
        padding_type=padding_type,
        use_instance_norm=use_in,
        tanh_constant=tanh_constant,
        input_pad=input_pad,
        total_stride=_total_stride(layers),
    )
    return spec, params


def _convert_block(block_mods: List[TorchObject]):
    """conv block: [pad?] conv norm relu [pad?] conv norm (models_video.lua:10-39)."""
    out: Dict[str, Any] = {}
    idx = 0
    dim = None
    for m in block_mods:
        t = m.torch_typename
        if t == "nn.SpatialConvolution":
            idx += 1
            out[f"conv{idx}"] = _conv_params(m)
            dim = int(m["nOutputPlane"])
        elif t in ("nn.InstanceNormalization", "nn.SpatialBatchNormalization"):
            out[f"norm{idx}"] = _norm_params(m)
    return out, dim


def _total_stride(layers) -> int:
    run = mx = 1
    for l in layers:
        if l.kind == "conv":
            run *= l.stride
        elif l.kind == "full_conv" and l.stride > 1:
            run //= l.stride
        elif l.kind == "upsample":
            run //= l.scale
        mx = max(mx, run)
    return mx


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


# ---------------------------------------------------------------------------
# VGG-16 loss network conversion
# ---------------------------------------------------------------------------

def import_vgg16(t7_obj: Any) -> Dict[str, Dict[str, np.ndarray]]:
    """Convert a Torch VGG-16 (nn.Sequential of conv/relu/pool) into the
    vgg.extract_features params dict keyed by Torch sequential index."""
    model = t7_obj
    if isinstance(t7_obj, dict) and "model" in t7_obj:
        model = t7_obj["model"]
    mods = _modules(model)
    params = {}
    for idx, m in enumerate(mods, start=1):
        if m.torch_typename in ("nn.SpatialConvolution", "cudnn.SpatialConvolution"):
            params[f"conv{idx:02d}"] = _conv_params(m)
    return params


def convert_model_file(t7_path: str, out_path: str, in_channels_hint: int = 0) -> None:
    """CLI helper: .t7 stylizer checkpoint -> native .npz model."""
    obj = load_t7(t7_path)
    spec, params = import_stylizer_numpy(obj)
    meta = {
        "arch": "<imported-t7>",
        "in_channels": spec.in_channels,
        "padding_type": spec.padding_type,
        "use_instance_norm": spec.use_instance_norm,
        "tanh_constant": spec.tanh_constant,
        "imported_from": t7_path,
        "layers": [
            {
                "kind": l.kind, "out_channels": l.out_channels, "ksize": l.ksize,
                "stride": l.stride, "scale": l.scale, "pad": l.pad,
                "pad_mode": l.pad_mode, "out_adjust": l.out_adjust,
                "block_padding": l.block_padding, "norm_after": l.norm_after,
                "relu_after": l.relu_after,
            }
            for l in spec.layers
        ],
        "input_pad": spec.input_pad,
        "total_stride": spec.total_stride,
    }
    model_ckpt.save_model(out_path, params, meta)
