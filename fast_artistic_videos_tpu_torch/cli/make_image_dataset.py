"""CLI: pack a directory of images into the MS-COCO-style single-image HDF5
that the synthetic training sources read (/{train2014,val2014}/images
(N, 3, H, W) uint8) — counterpart of
``fast_artistic_videos_tpu/cli/make_image_dataset.py`` (the reference
delegates this to fast-neural-style's make_style_dataset.py). Images are
resized bilinearly (antialiased when shrinking) with the port's
``flow.estimator.resize_bilinear``, on ``--device`` (the card unless
``--device cpu`` is given).

  python -m fast_artistic_videos_tpu_torch.cli.make_image_dataset \\
      --input_dir images --output_file images.h5 --height 256 --width 256
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from ..core import device as device_mod
from ..core import io
from ..flow.estimator import resize_bilinear

EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")


def resize(img: np.ndarray, h: int, w: int, device) -> np.ndarray:
    """(H, W, ...) float numpy -> (h, w, ...), as ``jax.image.resize``'s
    "bilinear", computed on `device`."""
    if img.shape[:2] == (h, w):
        return img
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
    x = x[..., None] if x.ndim == 2 else x
    y = resize_bilinear(x, (h, w)).cpu().numpy()
    return y[..., 0] if img.ndim == 2 else y


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_file", default="images.h5")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--val_fraction", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=device_mod.DEFAULT,
                   help="torch device of the resizes (default cuda)")
    args = p.parse_args(argv)
    device = device_mod.resolve(args.device)

    import h5py

    files = [
        os.path.join(root, f)
        for root, _, names in os.walk(args.input_dir)
        for f in names
        if f.lower().endswith(EXTS) and not f.startswith(".")
    ]
    random.Random(args.seed).shuffle(files)
    if args.max_images > 0:
        files = files[: args.max_images]
    if not files:
        raise SystemExit(f"no images found under {args.input_dir}")
    n_val = max(1, int(len(files) * args.val_fraction)) if len(files) > 1 else 0
    splits = {"train2014": files[n_val:], "val2014": files[:n_val]}

    with h5py.File(args.output_file, "w") as f:
        for split, items in splits.items():
            if not items:
                continue
            d = f.create_dataset(
                f"/{split}/images", (len(items), 3, args.height, args.width), np.uint8)
            for i, path in enumerate(items):
                img = resize(io.load_image(path), args.height, args.width, device)
                d[i] = np.clip(img * 255, 0, 255).astype(np.uint8).transpose(2, 0, 1)
            print(f"{split}: {len(items)} images")
    print(f"wrote {args.output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
