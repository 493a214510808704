"""The import check: nothing a run loads may be JAX or the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot), so the port, ``fast_artistic_videos_tpu_torch``, is not taken
for the JAX package, ``fast_artistic_videos_tpu``.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "fast_artistic_videos_tpu", "bench", "chip_smoke")
# what the plain reference may not load either: the program
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("fast_artistic_videos_tpu_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def found(modules: Iterable[str], forbidden=FORBIDDEN) -> List[str]:
    """The names among `modules` whose top-level name is forbidden."""
    bad = set(forbidden)
    return sorted(m for m in modules if top_level(m) in bad)


def loaded(forbidden=FORBIDDEN) -> List[str]:
    return found(list(sys.modules), forbidden)
