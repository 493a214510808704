"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into ONE shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds. The build runs at first use (never at
import) into ``fast_artistic_videos_tpu_torch/_build/``; the library's file
name carries a hash of the sources, so an edited source rebuilds and a stale
library is never loaded. Pointers and the stream go to C as ``c_void_p``
(passed as Python ints); :meth:`Kernel.call` makes the tensors' device
current for the launch when it is not, and appends that device's current
stream; every C entry returns ``cudaGetLastError()`` and :meth:`Kernel.call`
raises when it is not 0.

The launch path does no work that a launch does not need: each C function
is resolved once per process (:meth:`Library.entry`, no lock after the
first call), the device is switched only when the tensors' card is not the
thread's current one, and the stream's raw handle is read without building
a ``torch.cuda.Stream`` object.

A kernel's Python entry marked :func:`graph_break` is never held in the
flow provider's CUDA graphs (``flow.graphs``): a step's graph ends before
its launch, which runs eagerly between two replays, so every launch of the
kernel is a call of its entry on a card, counted and spanned as any other.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of every entry point (argtypes, the stream last); all return
# int (cudaError_t)
SIGNATURES = {
    "fav_warp_banded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fav_warp_banded_vec": [_P, _P, _P] + [_I] * 7 + [_P],
    "fav_conv_in": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    "fav_conv3x3_f32": [_P] * 8 + [_I] * 8 + [_P],
    "fav_strip_warp": [_P] * 6 + [_I] * 12 + [_P],
    "fav_strip_warp_sum": [_P, _P],
    "fav_conv_tc": [_P] * 8 + [_I] * 8 + [_P],
    "fav_front_tc": [_P] * 6 + [_I] * 8 + [_P],
    "fav_front_f32": [_P] * 6 + [_I] * 8 + [_P],
    "fav_upconv_f32": [_P] * 6 + [_I] * 8 + [_F, _P],
    "fav_correlation_f32": [_P] * 3 + [_I] * 6 + [_P],
}


class Library:
    """The compiled kernels, built once per process on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._entries = {}
        self.build_seconds = None
        self.build_log = ""

    def sources(self):
        return sorted(glob.glob(os.path.join(CSRC, "*.cu")))

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        for path in self.sources() + headers:
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def path(self) -> str:
        return os.path.join(BUILD_DIR, f"libfav_kernels_{self.digest()}.so")

    def get(self, verbose: bool = False):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(verbose)
            return self._lib

    def entry(self, name: str):
        """The C function `name` (the library is built or loaded on the
        first call); resolved once, then read without a lock."""
        fn = self._entries.get(name)
        if fn is None:
            fn = getattr(self.get(), name)
            self._entries[name] = fn
        return fn

    def _load(self, verbose: bool):
        out = self.path()
        if not os.path.exists(out):
            self._compile(out, verbose)
        lib = ctypes.CDLL(out)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib

    def _compile(self, out: str, verbose: bool):
        nvcc = _find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
        cmd += ["-o", tmp, *self.sources()]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.monotonic() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{self.build_log}")
        os.replace(tmp, out)  # atomic: a concurrent build never leaves a torn file


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


LIBRARY = Library()


def _raw_stream(index: int) -> int:
    """The cudaStream_t of card `index`'s current stream, as an int."""
    return torch._C._cuda_getCurrentRawStream(index)


class Kernel:
    """One kernel's launch counters plus the error check of its C entry.

    ``launches`` rises by one each time the wrapper launches the kernel and
    at no other time; ``routes[entry]`` counts the same launches by the C
    entry that took them (K2 and K4 have a float32 and a tensor-core
    route, K2 and K3 also the general template, K5 a single-map and a
    summing entry). :meth:`reset` sets both to 0. ``span`` names the span
    (``utils.profiling``) that a call of its Python entry opens on a card."""

    def __init__(self, name: str, source: str, replaces: str, span: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.span = span
        self.launches = 0
        self.routes = {}
        self._count_lock = threading.Lock()  # the flow thread launches too

    def reset(self):
        with self._count_lock:
            self.launches = 0
            self.routes = {}

    def call(self, name: str, device: torch.device, *args):
        """Launch C entry `name` on `device` (a tensor on cuda:N launches on
        card N, from any thread: the card is made current for the call when
        it is not), on that card's current stream, appended to `args`.
        Raises inside the capture of a step's graph (:func:`capturing`):
        only an entry marked :func:`graph_break` launches there."""
        if getattr(_GRAPH, "handler", None) is not None:
            raise RuntimeError(f"kernel {self.name} launched inside a step's graph capture: "
                               f"its Python entry needs _build.graph_break")
        fn = LIBRARY.entry(name)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            err = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} ({name}) failed: "
                               f"cudaError {err}")
        with self._count_lock:
            self.launches += 1
            self.routes[name] = self.routes.get(name, 0) + 1


_GRAPH = threading.local()           # .handler: of the step this thread captures


def graph_break(entry):
    """Mark `entry`, a hand-written kernel's Python entry, as one that a
    step's graph never holds. While this thread captures a step
    (:func:`capturing`), a call goes to the capture's handler, which ends
    the graph there and launches the kernel eagerly; at each replay the
    step calls the entry again by its module's attribute, so that whatever
    wraps it there sees every launch."""
    @functools.wraps(entry)
    def wrapped(*args, **kwargs):
        handler = getattr(_GRAPH, "handler", None)
        if handler is None:
            return entry(*args, **kwargs)
        return handler(entry, args, kwargs)
    return wrapped


@contextlib.contextmanager
def capturing(handler):
    """Around the capture of a step's graph on this thread:
    ``handler(entry, args, kwargs)`` takes each call of a
    :func:`graph_break` entry. None: no capture (the eager launch
    between two graphs)."""
    saved = getattr(_GRAPH, "handler", None)
    _GRAPH.handler = handler
    try:
        yield
    finally:
        _GRAPH.handler = saved


def no_grad_inputs(name: str, *tensors):
    """Raise when a kernel entry is asked to carry a gradient: under grad
    mode, an input or weight that requires grad. The kernels have no
    backward (their outputs come out of :meth:`Kernel.call` with no
    ``grad_fn``), so a gradient through them would be cut without a word.
    Checked on every device, so the CPU tests reach it too; callers that
    differentiate take the plain PyTorch path (``stylizer.apply(...,
    fused=False)``, ``ops.warp.bilinear_warp(..., differentiable=True)``).
    None and non-tensor arguments are skipped."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward; "
            f"run it under torch.no_grad() or take the differentiable plain path")


def ptr(t):
    """A tensor's data pointer for a ``c_void_p`` argument (None: NULL)."""
    return t.data_ptr() if t is not None else None
