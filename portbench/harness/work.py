"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work can take, the operations and bytes of the hand-written kernels'
launches (K1-K5) counted from their shapes and arguments (the files of
``portbench/kernels/`` name the entries and take these), and the model's
operations per frame counted on the reference.

Bytes count each input read once and each output written once, whatever a
kernel reads again; operations are multiply-adds counted as two.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM, dense rates; float32 runs with TF32 off, so outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the rate of `dtype`."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


def _nb(shape, itemsize: int) -> int:
    return int(np.prod(shape)) * itemsize


def warp_work(img_shape, itemsize: int):
    """K1, the banded warp of (N, H, W, C) by a float32 (N, H, W, 2) flow:
    the image and the flow read, the image's size written; two two-tap
    passes, a multiply and an add a tap."""
    n, h, w, c = img_shape
    nbytes = 2 * _nb(img_shape, itemsize) + _nb((n, h, w, 2), 4)
    return 8 * n * h * w * c, nbytes


def conv_work(x_shape, w_shape, out_hw, itemsize: int, *, stats=True, eff=False,
              skip=False, emit=False):
    """A conv launch of K2, K3 or K4: x (N, H, W, Cin), w (Cout, Cin, kh,
    kw), output (N, Ho, Wo, Cout). Reads x, the weights and bias (and the
    prologue's affine and the residual skip's used rows where given);
    writes y (and the float32 norm statistics, and the prologue's result
    where emitted)."""
    n, h, w, cin = x_shape
    cout, _, kh, kw = w_shape
    ho, wo = out_hw
    flops = 2 * kh * kw * cin * cout * n * ho * wo
    nbytes = (_nb(x_shape, itemsize) + _nb(w_shape, itemsize) + cout * 4
              + _nb((n, ho, wo, cout), itemsize))
    if stats:
        nbytes += 2 * cout * 4
    if eff:
        nbytes += 2 * cin * 4
    if skip:
        nbytes += _nb(x_shape, itemsize)
    if emit:
        nbytes += _nb(x_shape, itemsize)
    return flops, nbytes


def _dname(t) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def warp_launch(img, flow, band):
    """K1 (``warp_kernel.warp_banded``): (flops, bytes, dtype)."""
    return (*warp_work(tuple(img.shape), img.element_size()), _dname(img))


def chain_launch(x, wt, b, eff=None, pre_relu=False, skip=None, emit_input=False):
    """K2 (``rblock_kernel.chain_conv``) on one (H, W, Cin) frame, VALID:
    (flops, bytes, dtype)."""
    h, wd, _ = x.shape
    return (*conv_work((1,) + tuple(x.shape), tuple(wt.shape), (h - 2, wd - 2),
                       x.element_size(), eff=eff is not None, skip=skip is not None,
                       emit=emit_input), _dname(x))


def front_launch(x, wt, b, stride, pad, eff=None, relu=False):
    """K3 (``front_kernel.same_conv``) on one (H, W, Cin) frame:
    (flops, bytes, dtype)."""
    h, wd, _ = x.shape
    k = wt.shape[2]
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    return (*conv_work((1,) + tuple(x.shape), tuple(wt.shape), (ho, wo), x.element_size(),
                       eff=eff is not None), _dname(x))


def block_launch(pad: int):
    """K4 (``conv_kernel.conv3x3`` with pad 1, ``conv3x3_valid`` with 0) on
    an (N, H, W, Cin) batch: its counter of (flops, bytes, dtype)."""
    def count(x, wt, b, relu=False):
        _, h, wd, _ = x.shape
        return (*conv_work(tuple(x.shape), tuple(wt.shape), (h + 2 * pad - 2, wd + 2 * pad - 2),
                           x.element_size(), stats=False), _dname(x))
    return count


def mapped_area(m: np.ndarray, sentinel: float = 99999.0) -> int:
    """The bounding box area of the pixels a static border map reaches."""
    mapped = np.all(np.abs(m) < sentinel / 2, axis=-1)
    if not mapped.any():
        return 0
    rows = np.where(mapped.any(axis=1))[0]
    cols = np.where(mapped.any(axis=0))[0]
    return int((rows[-1] - rows[0] + 1) * (cols[-1] - cols[0] + 1))


def strip_prior_work(face: int, areas, terms, divided: bool):
    """K5's border prior of one face: the strip of each term's source read
    (three float32 channels a pixel; the divisor too at the divided
    positions), the whole float32 face written; four taps a channel."""
    strip = sum(areas[m] for m, _, _ in terms)
    nbytes = strip * 3 * 4 + _nb((face, face, 3), 4) + (strip * 4 if divided else 0)
    return 8 * 3 * strip, nbytes


def strip_blend_work(face: int, areas, blend_terms):
    """K5's cross-face blend of six faces: each face and its four
    neighbours' strips read, the seam mask and the divisor read, six faces
    written."""
    strip = sum(areas[m] for terms in blend_terms for m, _, _ in terms)
    nbytes = strip * 3 * 4 + 2 * 6 * _nb((face, face, 3), 4) + 2 * _nb((face, face), 4)
    return 8 * 3 * strip + 4 * 6 * face * face * 3, nbytes


# ---------------------------------------------------------------------------
# the model's operations per frame, on the reference, by torch's counter
# ---------------------------------------------------------------------------

def _meta_tree(tree):
    return {k: _meta_tree(v) if isinstance(v, dict) else torch.empty(v.shape, device="meta")
            for k, v in tree.items()}


def model_flops(net, params_like, flow, flow_like, frame_hw, n: int, flow_scale: float) -> int:
    """Operations of one steady step of n synchronised streams: the
    stylizer on n frames at the stride-padded size by FlopCounterMode, on
    meta tensors (only shapes), and the flow of n new frames and both
    directions by the flow family's count (``flow.flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import stylizer as net_ref

    h, w = frame_hw
    m = net.total_stride
    hp, wp = -(-h // m) * m, -(-w // m) * m
    p = _meta_tree(params_like)
    with FlopCounterMode(display=False) as fc:
        net_ref.forward(p, net, torch.empty((n, hp, wp, net.in_channels), device="meta"))
    return int(fc.get_total_flops()) + flow.flops(flow_like, frame_hw, n, flow_scale)
