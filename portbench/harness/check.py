"""How ``correct`` is decided: the program's uint8 outputs against the
plain float32 reference, on frames drawn from the seed.

The stylization is a recurrence: each output is computed from the one
before. With the benchmark's random weights the recurrence amplifies a
difference about threefold a frame, so two sound float32 implementations
part after a dozen frames (PERF.md). The reference therefore follows the
program step by step from the program's own state: for a drawn frame t it
takes the program's carried float32 state of frame t - 1 (the stylized
frame, or the six blended faces), recomputes the flow of the frames
before t and t itself, and stylizes frame t. Two stages stand apart: each
stream's first frame, which starts from no state, is recomputed whole;
and the state handed over must quantize to exactly the frame the program
delivered for t - 1.

Two numbers over the drawn frames, each with a limit of its own
(``portbench/limits/<cell>.json``, from sound runs of the program and of
its bfloat16 control; see PERF.md):

  * ``mean_abs_max``: the largest mean absolute difference of a frame, in
    uint8 levels;
  * ``off2_max``: the largest share (%) of a frame's values that differ
    by two levels or more.

A drawn frame or state that is missing, or a state that does not match
its delivered frame, fails the check whatever the numbers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

NUMBERS = ("mean_abs_max", "off2_max")


def frame_gaps(got: np.ndarray, want: np.ndarray) -> Tuple[float, float]:
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return float(d.mean()), float((d >= 2).mean() * 100.0)


def drawn(seed: int, stream: int, every: int, cap: int) -> np.ndarray:
    """The frame indices < cap checked on a stream: frame 0, and each
    other frame with probability 1 / every, from the seed."""
    rng = np.random.default_rng([seed, 3, stream])
    bits = rng.random(cap) < 1.0 / every
    bits[0] = True
    return np.flatnonzero(bits)


def reference_streams(cfg, params, flow, flow_params, device):
    """A factory of reference streams for the cell's geometry, their flow
    by the flow family `flow` (``reference/flow_<model>.py``)."""
    from ..reference import stylizer as net_ref
    from ..reference import video as vref

    net = net_ref.parse(cfg["arch"], int(cfg["in_channels"]))
    geo = cfg["geometry"]
    scale = float(cfg["flow"]["scale"])
    k = int(cfg["occlusions_min_filter"])
    if geo["kind"] == "cube_faces":
        return lambda: vref.Faces(params, net, flow, flow_params, scale, int(geo["face"]),
                                  int(geo["overlap"]), k, device)
    return lambda: vref.Stream2D(params, net, flow, flow_params, scale, k)


def _state_u8(state) -> np.ndarray:
    from ..reference import stylizer as net_ref

    if isinstance(state, (list, tuple)):
        return np.stack([net_ref.quantize(s.float()).cpu().numpy() for s in state])
    return net_ref.quantize(state.float()).cpu().numpy()


def compare(outputs: Dict[tuple, np.ndarray], states: Dict[tuple, object],
            samples: Dict[int, List[int]], frame_of, make_stream, device
            ) -> Tuple[Dict[str, float], List[str]]:
    """Recompute each drawn frame on the reference (``frame_of(s, t)``: the
    uint8 input of stream s at t) and compare it with the program's: the
    numbers and the faults found."""
    from ..reference import stylizer as net_ref

    def dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    worst = {n: 0.0 for n in NUMBERS}
    faults = []
    with net_ref.float32():
        for s, ts in sorted(samples.items()):
            for t in ts:
                got = outputs.get((s, t))
                if got is None:
                    faults.append(f"stream {s} frame {t}: no output")
                    continue
                ref = make_stream()
                if t > 0:
                    state, before = states.get((s, t - 1)), outputs.get((s, t - 1))
                    if state is None or before is None:
                        faults.append(f"stream {s} frame {t - 1}: no state")
                        continue
                    if not np.array_equal(_state_u8(state), before):
                        faults.append(f"stream {s} frame {t - 1}: the carried state is not "
                                      f"the frame delivered")
                    state = ([x.to(device) for x in state] if isinstance(state, (list, tuple))
                             else state.to(device))
                    ref.resume(state, [dev(frame_of(s, u)) for u in range(max(0, t - 2), t)])
                want = ref.step(dev(frame_of(s, t)))
                mean_abs, off2 = frame_gaps(got, want.cpu().numpy())
                worst["mean_abs_max"] = max(worst["mean_abs_max"], mean_abs)
                worst["off2_max"] = max(worst["off2_max"], off2)
    return worst, faults


def judge(numbers: Dict[str, float], faults: List[str], limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit and no fault. Without limits a run is not correct."""
    shown = {}
    ok = not faults and limits is not None
    for n in NUMBERS:
        lim = None if limits is None else float(limits[n]["limit"])
        shown[n] = {"value": numbers.get(n), "limit": lim}
        if lim is None or numbers.get(n) is None or numbers[n] > lim:
            ok = False
    return ok, shown
