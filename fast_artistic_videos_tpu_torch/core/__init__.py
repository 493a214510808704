"""Frame and flow file I/O (``io``) and the CLI options (``config``): the
port's own copies of the JAX package's jax-free core modules, so that the
port reads and writes the same files and takes the same flags."""

from . import config, io

__all__ = ["config", "io"]
