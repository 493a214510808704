"""Model registry: the named pretrained styles of the reference and how
their checkpoints map into this framework.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/models/registry.py``
(the standard library only). Its asset paths are the port's
``models.checkpoint.ASSETS``: the JAX package's asset folder, whose files
are read, not imported.

The reference ships 6 video+image style pairs and 2 VR models as Torch7
checkpoints behind download scripts (models/download_models.sh:6-19,
download_models_vr.sh:3-5). This registry records the catalog; checkpoints
convert with:

    python -m fast_artistic_videos_tpu_torch.cli.import_t7 model \\
        checkpoint-candy-video.t7 candy-video.npz

and the VGG-16 loss network with ``import_t7 vgg vgg16.t7 vgg16.npz``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from .checkpoint import ASSETS as ASSETS_DIR


@dataclasses.dataclass(frozen=True)
class StyleEntry:
    name: str
    video_t7: str                 # reference checkpoint filename
    image_t7: str
    style_image: Optional[str]    # bundled style JPEG, if any
    vr: bool = False


CATALOG: Dict[str, StyleEntry] = {
    e.name: e
    for e in [
        StyleEntry("candy", "checkpoint-candy-video.t7", "checkpoint-candy-image.t7",
                   "styles/candy.jpg"),
        StyleEntry("mosaic", "checkpoint-mosaic-video.t7", "checkpoint-mosaic-image.t7",
                   "styles/mosaic.jpg"),
        StyleEntry("picasso", "checkpoint-picasso-video.t7", "checkpoint-picasso-image.t7",
                   "styles/picasso.jpg"),
        StyleEntry("schlief", "checkpoint-schlief-video.t7", "checkpoint-schlief-image.t7",
                   "styles/schlief.jpg"),
        StyleEntry("scream", "checkpoint-scream-video.t7", "checkpoint-scream-image.t7",
                   "styles/scream.jpg"),
        StyleEntry("WomenHat", "checkpoint-WomenHat-video.t7", "checkpoint-WomenHat-image.t7",
                   "styles/WomenHat.jpg"),
        StyleEntry("scream-vr", "checkpoint-scream-vr-video.t7", "", None, vr=True),
        StyleEntry("mosaic-vr", "checkpoint-mosaic-vr-video.t7", "", None, vr=True),
    ]
}


def style_fixture(name: str) -> str:
    """Path to the bundled procedural style-image fixture for a catalog
    style: procedural stand-ins for the reference's copyrighted style
    JPEGs, with loosely matching palette and structure (generated by
    tools/make_style_fixtures.py), sufficient as training and eval inputs
    for tests and demos."""
    entry = CATALOG.get(name)
    if entry is None:
        raise KeyError(f"unknown style {name!r}; catalog: {sorted(CATALOG)}")
    base = name.replace("-vr", "")
    path = os.path.join(ASSETS_DIR, "styles", f"{base}.png")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bundled style fixture missing: {path} "
            f"(regenerate with tools/make_style_fixtures.py)")
    return path


def bundled_flow_weights() -> str:
    """Path to the bundled trained PWC-lite flow weights (the CLIs' and
    ``flow.estimator.load_params``'s ``bundled``)."""
    path = os.path.join(ASSETS_DIR, "flow_pwclite.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bundled flow weights missing: {path} (retrain with "
            f"fast_artistic_videos_tpu.flow.train.train_flow_synthetic)")
    return path


def find_converted(name: str, models_dir: str = "models") -> Tuple[str, str]:
    """Locate converted .npz checkpoints for a catalog style; raises with a
    conversion hint when missing."""
    entry = CATALOG.get(name)
    if entry is None:
        raise KeyError(f"unknown style {name!r}; catalog: {sorted(CATALOG)}")
    vid = os.path.join(models_dir, f"{name}-video.npz")
    img = os.path.join(models_dir, f"{name}-image.npz")
    missing = [p for p in ((vid,) if entry.vr else (vid, img)) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"converted checkpoints missing: {missing}. Convert the reference "
            f"t7 files with: python -m fast_artistic_videos_tpu_torch.cli.import_t7 "
            f"model {entry.video_t7} {vid}"
        )
    return vid, img
