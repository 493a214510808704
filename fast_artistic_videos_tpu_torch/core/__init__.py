"""Frame and flow file I/O (``io``) and the CLI options (``config``): the
JAX package's jax-free core modules, shared as they are so that the port
reads and writes the same files and takes the same flags."""

from fast_artistic_videos_tpu.core import config, io

__all__ = ["config", "io"]
