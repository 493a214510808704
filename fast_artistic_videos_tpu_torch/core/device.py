"""The device of the port's library entry points.

Every entry point that places tensors (``StylizerEngine``, ``FlowEstimator``,
the streaming flow providers, ``load_model``, ``params_from_numpy``,
``flow.estimator.load_params``) runs on the card unless the caller asks for
the CPU with ``device="cpu"``. Without a card the default raises: there is
no silent fallback to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """`device` as a torch.device; a CUDA device raises when no card is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!s}: no CUDA device is available "
                           "(pass device=\"cpu\" to run the plain versions on the CPU)")
    return dev
