"""The flow family ``pwclite``: the compact PWC-style estimator of
``reference/flow.py`` behind the interface that ``flow.StreamingFlow``,
the harness's weights and its operation count take. A configuration whose
``flow`` object names no ``model`` runs this family.

A family is this file and ``flows/<model>.py`` (the program's half); both
are found by the model's name. This half imports nothing of the program:

  * ``draw(seed, device)``: weights from the seed, on a generator stream
    of the family's own;
  * ``load(path, device)`` / ``save(path, params)``: the program's flow
    checkpoint, read and written;
  * ``STRIDE``, ``scaled(h, w, scale)``: the flow's resolution and the
    multiple it is padded to;
  * ``features(params, frames_u8, scale)``: what a pair reuses of a frame;
  * ``pair(params, feats_a, feats_b)``: the flow a -> b at the padded flow
    resolution, in its pixels;
  * ``flops(params_like, frame_hw, n, scale)``: the operations of n new
    frames and both directions of each pair.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import flow

STRIDE = flow.STRIDE
scaled = flow.scaled
load = flow.load_weights
features = flow.prep
pair = flow.refine

# the estimator heads' widths and the context head's, as the bundled
# checkpoint holds them
ESTIMATOR_CHANNELS = (96, 64, 32)
CONTEXT_CHANNELS = (64, 64, 48)


def layers():
    """[(name, cin, cout)] of every 3x3 conv, in draw order."""
    out, cin = [], 3
    for lvl, c in enumerate(flow.PYRAMID_CHANNELS):
        out += [(f"pyr{lvl}_a", cin, c), (f"pyr{lvl}_b", c, c)]
        cin = c
    cost = (2 * flow.COST_RADIUS + 1) ** 2
    for lvl, c in enumerate(flow.PYRAMID_CHANNELS):
        x = cost + c + 2
        for i, d in enumerate(ESTIMATOR_CHANNELS):
            out.append((f"est{lvl}_{i}", x, d))
            x = d
        out.append((f"est{lvl}_out", x, 2))
    x = ESTIMATOR_CHANNELS[-1] + 2
    for i, d in enumerate(CONTEXT_CHANNELS):
        out.append((f"ctx_{i}", x, d))
        x = d
    out.append(("ctx_out", x, 2))
    return out


def draw(seed: int, device) -> dict:
    """Kernels (OIHW) and biases uniform in +-1/sqrt(fan_in), from one
    ``torch.rand`` call on a generator of the family's own stream."""
    convs = layers()
    sizes = [(d * c * 9, d) for _, c, d in convs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 0xF10]).generate_state(
        1, np.uint64)[0]) % (2 ** 63))
    flat = torch.rand(sum(a + b for a, b in sizes), generator=gen, device=device) * 2 - 1
    tree, at = {}, 0
    for (name, c, d), (nw, nb) in zip(convs, sizes):
        stdv = 1.0 / float(c * 9) ** 0.5
        w = flat[at:at + nw].view(d, c, 3, 3) * stdv
        b = flat[at + nw:at + nw + nb] * stdv
        at += nw + nb
        tree[name] = {"w": w.contiguous(), "b": b.contiguous()}
    return tree


def save(path: str, params: dict) -> None:
    """The npz the program's ``flow.estimator.load_params`` reads:
    ``name/leaf`` keys, kernels HWIO."""
    arrays = {}
    for name, leaves in params.items():
        for leaf, t in leaves.items():
            a = t.detach().float().cpu().numpy()
            arrays[f"{name}/{leaf}"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def flops(params_like, frame_hw, n: int, scale: float) -> int:
    """Operations of the pyramids of n new frames at the stride-padded flow
    size and of both refinement directions, by FlopCounterMode on meta
    tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = frame_hw
    hs, ws = scaled(h, w, scale)
    fh, fw = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
    fp = {k: {leaf: torch.empty(t.shape, device="meta") for leaf, t in v.items()}
          for k, v in params_like.items()}
    with FlopCounterMode(display=False) as fc:
        feats = flow.pyramid(fp, torch.empty((n, fh, fw, 3), device="meta"))
        pair(fp, feats, feats)
        pair(fp, feats, feats)
    return int(fc.get_total_flops())
