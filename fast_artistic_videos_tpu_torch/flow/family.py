"""The flow family of a checkpoint: the one place that turns flow weights
into an estimator. PWC-lite (``flow.estimator.FlowEstimator``, the bundled
weights) and FlowNet 2.0 (``flow.flownet2.FlowNet2Estimator``) share the
checkpoint format (an npz of ``name/leaf`` keys, read by
``flow.estimator.load_params``) and the streaming interface (``prep``,
``prep_batch``, ``refine_pair``, ``refine_pair_batch``); the keys say which
one a checkpoint holds. Every entry that takes ``--flow_model`` or
``flow_params`` builds its estimator here.
"""

from __future__ import annotations

import torch

from ..core import device as device_mod
from . import estimator, flownet2


def family(params) -> str:
    """``"flownet2"`` or ``"pwclite"``, by the parameter tree's keys."""
    return "flownet2" if flownet2.is_flownet2(params) else "pwclite"


def make_estimator(params, dtype=torch.float32, device=device_mod.DEFAULT):
    """The estimator of the family that `params` belong to, on `device`
    (the card unless ``device="cpu"``), its features in `dtype`."""
    if family(params) == "flownet2":
        return flownet2.FlowNet2Estimator(params, dtype=dtype, device=device)
    return estimator.FlowEstimator(params, dtype=dtype, device=device)


def load_estimator(path: str, dtype=torch.float32, device=device_mod.DEFAULT):
    """:func:`make_estimator` of a checkpoint (``bundled``: PWC-lite's)."""
    return make_estimator(estimator.load_params(path, device), dtype=dtype, device=device)
