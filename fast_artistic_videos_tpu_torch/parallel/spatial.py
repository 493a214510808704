"""Spatial (height) sharding of one frame over several devices —
counterpart of ``fast_artistic_videos_tpu/parallel/spatial.py``.

The per-frame recurrence is sequential, so the only way to put several
cards on ONE video stream is to split each frame across them. The JAX
package lets XLA's GSPMD partition every conv and insert its halo
exchanges; PyTorch has no such partitioner, so here the rows are split by
hand, in one process over a list of devices (repeats allowed: the CPU
tests use ["cpu"] * k, a one-card machine cuda:0 twice).

At every layer of ``spec.layers`` each shard owns a contiguous, even share
of the layer's GLOBAL output rows, recomputed per level (the stride-2
convs halve the height, the upsamplings double it, the VALID block convs
shrink it by 2 each). To compute its rows a shard pulls the conv's halo
rows from its neighbours by peer copy (``Tensor.to``), and pads only at
the true frame edges: the net's reflect pre-pad (``spec.input_pad``) and
each layer's own padding mode; the width is whole on every shard and pads
locally. Each norm sums (sum, sum of squares, count) over the owned rows
only, across shards, before its affine: the one-pass statistics of
``models.stylizer.instance_norm``. The residual skip crops are taken in
global row coordinates.

The shards run the stylizer's plain route (PyTorch convs, conv by conv),
as the JAX package's ``SpatialStylizer`` runs XLA's convs rather than its
Pallas kernels. Every op is differentiable (slices, peer copies, sums), so
the same code carries the (data, space) training of
``parallel.mesh.make_mesh_2d``: gradients flow back through the halo
copies and the parameter copies to the leaves.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..models import stylizer
from ..models.stylizer import _affine, _nchw, _nhwc, upsample_nearest

# one shard of an activation: global rows [lo, hi), all columns, on a device
Shard = Tuple[int, int, torch.Tensor]


def split_rows(h: int, k: int) -> List[Tuple[int, int]]:
    """Even contiguous row ranges of k shards over h rows."""
    if h < k:
        raise ValueError(f"{h} rows cannot be split over {k} shards")
    return [(i * h // k, (i + 1) * h // k) for i in range(k)]


def _source_row(r: int, h: int, mode: str) -> Optional[int]:
    """The global row that padded row r reads (None: a zero row)."""
    if 0 <= r < h:
        return r
    if mode == "reflect":
        return -r if r < 0 else 2 * (h - 1) - r
    if mode == "replicate":
        return min(max(r, 0), h - 1)
    return None


def gather_rows(shards: Sequence[Shard], h: int, lo: int, hi: int, mode: str,
                device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of the global activation that `shards` hold (height
    h), on `device`; rows outside [0, h) pad by `mode` ("zero", "reflect",
    "replicate"). Runs of consecutive rows of one shard move as one slice
    (reversed runs, the reflected edge, as one flipped slice)."""
    like = shards[0][2]
    segs, run = [], None     # run: [shard index, first local row, last, step]

    def flush():
        if run is None:
            return
        i, a, b, step = run
        t = shards[i][2]
        piece = t[:, a:b + 1] if step >= 0 else t[:, b:a + 1].flip(1)
        segs.append(piece.to(device))

    for r in range(lo, hi):
        src = _source_row(r, h, mode)
        if src is None:
            flush()
            run = None
            segs.append(torch.zeros((like.shape[0], 1) + tuple(like.shape[2:]),
                                    dtype=like.dtype, device=device))
            continue
        i = next(j for j, (a, b, _) in enumerate(shards) if a <= src < b)
        local = src - shards[i][0]
        if run is not None and run[0] == i and local - run[2] in (1, -1) and (
                run[3] == 0 or local - run[2] == run[3]):
            run[3], run[2] = local - run[2], local
            continue
        flush()
        run = [i, local, local, 0]
    flush()
    return segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)


def _pad_cols(x, p: int, mode: str):
    if p == 0:
        return x
    mode = {"zero": "constant", "reflect": "reflect", "replicate": "replicate"}[mode]
    return _nhwc(F.pad(_nchw(x), (p, p, 0, 0), mode=mode))


class _Sharded:
    """One forward over k devices; ``params[i]`` is the parameter tree on
    ``devices[i]``."""

    def __init__(self, spec, params, devices):
        self.spec, self.params, self.devices = spec, params, devices

    def _pad_layer(self, xs, h: int, p: int, mode: str):
        """Pad rows and columns by p (the net's input pre-pad)."""
        hn = h + 2 * p
        return [(a, b, _pad_cols(gather_rows(xs, h, a - p, b - p, mode, d), p, mode))
                for (a, b), d in zip(split_rows(hn, len(xs)), self.devices)], hn

    def _conv(self, xs, h: int, key, k: int, stride: int, p: int, mode: str):
        """A k x k conv (stride, padding p by mode) of the sharded rows;
        key(i) is the {w, b} node on shard i."""
        ho = (h + 2 * p - k) // stride + 1
        out = []
        for i, ((a, b), d) in enumerate(zip(split_rows(ho, len(xs)), self.devices)):
            x = gather_rows(xs, h, a * stride - p, (b - 1) * stride - p + k, mode, d)
            node = key(i)
            out.append((a, b, stylizer.conv2d(_pad_cols(x, p, mode), node["w"], node["b"],
                                              stride, 0)))
        return out, ho

    def _full_conv(self, xs, h: int, node_of, layer):
        """Transposed conv (Torch SpatialFullConvolution): each shard runs
        ``F.conv_transpose2d`` on the input rows that reach its output rows
        (no row padding) and crops; the columns take the layer's padding."""
        k, s, p, adj = layer.ksize, layer.stride, layer.pad, layer.out_adjust
        ho = (h - 1) * s - 2 * p + k + adj
        out = []
        for i, ((a, b), d) in enumerate(zip(split_rows(ho, len(xs)), self.devices)):
            i_lo = max(0, -(-(a + p - k + 1) // s))
            i_hi = min(h - 1, (b - 1 + p) // s)
            x = gather_rows(xs, h, i_lo, i_hi + 1, "zero", d)
            # local output row j is global row j + i_lo * s - p
            start = a + p - i_lo * s
            extra = max(0, b + p - i_lo * s - ((i_hi - i_lo) * s + k))
            node = node_of(i)
            wt = node["w"].flip(2, 3).transpose(0, 1)
            with device_mod.float32_convs():
                y = F.conv_transpose2d(_nchw(x), wt, None, s, (0, p), (extra, adj))
            y = _nhwc(y) + node["b"]
            out.append((a, b, y[:, start:start + b - a]))
        return out, ho

    def _upsample(self, xs, h: int, sc: int):
        ho = h * sc
        out = []
        for (a, b), d in zip(split_rows(ho, len(xs)), self.devices):
            i_lo, i_hi = a // sc, (b - 1) // sc + 1
            x = upsample_nearest(gather_rows(xs, h, i_lo, i_hi, "zero", d), sc)
            out.append((a, b, x[:, a - i_lo * sc:a - i_lo * sc + b - a]))
        return out, ho

    def _norm(self, xs, node_of):
        """Instance norm (or batch norm) over the global rows: per-shard
        (sum, sum of squares, count) over owned rows, summed across shards
        on the first device."""
        use_in = self.spec.use_instance_norm
        p0 = node_of(0)
        if not use_in and "running_mean" in p0:
            stats = None
        else:
            dims = (1, 2) if use_in else (0, 1, 2)
            d0 = self.devices[0]
            s1 = s2 = None
            count = 0
            for _, _, x in xs:
                xf = x.float()
                a1 = xf.sum(dim=dims, keepdim=True).to(d0)
                a2 = (xf * xf).sum(dim=dims, keepdim=True).to(d0)
                s1 = a1 if s1 is None else s1 + a1
                s2 = a2 if s2 is None else s2 + a2
                count += x.shape[1] * x.shape[2] * (1 if use_in else x.shape[0])
            mean = s1 / count
            stats = (mean, torch.clamp(s2 / count - mean * mean, min=0.0))
        out = []
        for i, (a, b, x) in enumerate(xs):
            node = node_of(i)
            if stats is None:
                mean, var = node["running_mean"].float(), node["running_var"].float()
            else:
                mean, var = (t.to(x.device) for t in stats)
            es = torch.rsqrt(var + 1e-5) * node["scale"].float()
            eb = node["bias"].float() - mean * es
            out.append((a, b, _affine(x, es, eb)))
        return out

    @staticmethod
    def _map(xs, fn):
        return [(a, b, fn(x)) for a, b, x in xs]

    def _block(self, xs, h: int, name: str, layer, residual: bool):
        pt = layer.block_padding
        valid = pt in ("none", "reflect-start")
        p, mode = (0, "zero") if valid else (1, "zero" if pt == "zero" else pt)

        def node(i, *path):
            t = self.params[i][name]
            for k in path:
                t = t[k]
            return t
        y, h1 = self._conv(xs, h, lambda i: node(i, "conv1"), 3, 1, p, mode)
        y = self._map(self._norm(y, lambda i: node(i, "norm1")), torch.relu)
        y, h2 = self._conv(y, h1, lambda i: node(i, "conv2"), 3, 1, p, mode)
        y = self._norm(y, lambda i: node(i, "norm2"))
        if not residual:
            return y, h2
        out = []
        for (a, b, t), d in zip(y, self.devices):
            if valid:   # shave(x, 2) in global rows
                skip = gather_rows(xs, h, a + 2, b + 2, "zero", d)[:, :, 2:-2]
            else:
                skip = gather_rows(xs, h, a, b, "zero", d)
            out.append((a, b, t + skip))
        return out, h2

    def forward(self, xs, h: int):
        spec = self.spec
        if spec.input_pad:
            xs, h = self._pad_layer(xs, h, spec.input_pad, "reflect")
        for li, layer in enumerate(spec.layers):
            name = f"layer{li:02d}"
            if layer.kind == "conv":
                p, mode = ((layer.ksize - 1) // 2, layer.pad_mode) if layer.pad_mode \
                    else (layer.pad, "zero")
                xs, h = self._conv(xs, h, lambda i: self.params[i][name], layer.ksize,
                                   layer.stride, p, mode)
            elif layer.kind == "full_conv":
                xs, h = self._full_conv(xs, h, lambda i: self.params[i][name], layer)
            elif layer.kind == "upsample":
                xs, h = self._upsample(xs, h, layer.scale)
            else:
                xs, h = self._block(xs, h, name, layer, layer.kind == "res_block")
            if layer.norm_after:
                xs = self._norm(xs, lambda i: self.params[i][name + "_norm"])
            if layer.relu_after:
                xs = self._map(xs, torch.relu)
        return self._map(xs, lambda x: torch.tanh(x) * spec.tanh_constant), h


class SpatialStylizer:
    """Height-sharded stylizer forward for very large frames (4K and more)
    or latency-bound streams: one frame, several devices.

    spec, params: the stylizer (``models.checkpoint.load_model`` or
    ``stylizer.init_params``); params live anywhere and are copied to each
    device (cached, unless a leaf requires grad: then the copies are made
    per call, so gradients reach the leaves). devices: see
    :func:`core.device.resolve_all` (default: every card)."""

    def __init__(self, spec, params, devices=None):
        self.spec = spec
        self.params = params
        self.devices = device_mod.resolve_all(devices)
        self._replicas = None

    def _param_copies(self):
        if any(t.requires_grad for t in stylizer.leaves(self.params)):
            return [stylizer.to_device(self.params, d) for d in self.devices]
        if self._replicas is None:
            self._replicas = [stylizer.to_device(self.params, d) for d in self.devices]
        return self._replicas

    def shards(self, x) -> List[Shard]:
        """x: (N, H, W, in_channels) in VGG space (numpy or a tensor on any
        device). Returns each device's (lo, hi, output rows) of the
        (N, H, W, 3) output, in VGG space."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        h = x.shape[1]
        xs = [(a, b, x[:, a:b].to(d))
              for (a, b), d in zip(split_rows(h, len(self.devices)), self.devices)]
        out, _ = _Sharded(self.spec, self._param_copies(), self.devices).forward(xs, h)
        return out

    def __call__(self, x) -> torch.Tensor:
        """The whole (N, H, W, 3) output on the first device."""
        d0 = self.devices[0]
        return torch.cat([t.to(d0) for _, _, t in self.shards(x)], dim=1)
