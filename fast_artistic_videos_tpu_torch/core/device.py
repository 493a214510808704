"""The device of the port's library entry points.

Every entry point that places tensors (``StylizerEngine``, ``FlowEstimator``,
the streaming flow providers, ``load_model``, ``params_from_numpy``,
``flow.estimator.load_params``) runs on the card unless the caller asks for
the CPU with ``device="cpu"``. Without a card the default raises: there is
no silent fallback to the CPU.

The port's cuDNN convolutions and its float32 matrix products (the
evaluator's Gram matrices) run inside :func:`float32_convs`, so a float32
conv or product is a float32 one whatever ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` say (PyTorch's default for
the cuDNN flag, True, runs convs in TF32).
"""

from __future__ import annotations

import threading

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


def resolve_all(devices=None):
    """A list of devices: every card for None (or "cuda"), else the given
    device or list of devices, each through :func:`resolve` (repeats
    allowed: the CPU tests pass ["cpu", "cpu"])."""
    if devices is None or (isinstance(devices, str) and devices == "cuda"):
        resolve("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [resolve(d) for d in devices]


class _Float32Convs:
    """Context manager: cuDNN convolutions and cuBLAS matrix products
    inside it run with TF32 off. The flags are process-wide and the flow
    provider's thread convolves while the stylizer does, so entries are
    counted across threads: the first to enter saves the caller's flags and
    turns TF32 off, the last to leave puts the flags back."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = self._saved
        return False


_FLOAT32_CONVS = _Float32Convs()


def float32_convs():
    """The scope around every cuDNN convolution of the port (the stylizer's
    plain convs, the flow estimator's convs, the VGG-16 loss network) and
    every float32 matrix product (``ops.gram``)."""
    return _FLOAT32_CONVS
