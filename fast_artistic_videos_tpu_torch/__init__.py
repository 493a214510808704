"""fast_artistic_videos_tpu_torch — the PyTorch/CUDA port of
``fast_artistic_videos_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``models/stylizer.py`` here is the counterpart of
``fast_artistic_videos_tpu/models/stylizer.py``) and keeps its public array
conventions so the two can be compared like for like:

  * frames are (H, W, 3) RGB in [0, 1] (float32) or uint8;
  * flow is (H, W, 2) with channel 0 = dx and channel 1 = dy;
  * stylizer activations at the ``apply`` boundary are NHWC.

Inside, convolutions run on NCHW views (channels-last memory, so an NHWC
tensor permuted to NCHW costs no copy) and parameters are OIHW tensors.

Every Pallas kernel of the JAX package (K1-K5: the banded warp, the
residual-chain conv, the front conv, the block conv and the VR strip warp)
has a hand-written CUDA kernel for Hopper under ``csrc/`` (built at first
use by ``ops/_build.py``), and one kernel replaces no Pallas kernel (K6:
the stylizer's nearest 2x upsample folded into the conv after it). Each
kernel wrapper runs its plain PyTorch
version for a CPU tensor and launches the kernel, or raises, for a CUDA
tensor — there is no fallback. Library entry points run on the card
unless the caller passes ``device="cpu"`` (``core/device.py``).

The package imports ``torch`` and numpy and never ``jax`` nor any module of
the JAX package: it keeps its own copies of the JAX package's jax-free
modules (``core.io``, ``core.config``, ``models.arch_dsl``,
``utils.pipeline``, ``video.vr_geometry``) and only reads the JAX package's
weight files from ``fast_artistic_videos_tpu/assets/``.
"""

__version__ = "0.1.0"
