"""CLI: convert Torch7 checkpoints into native .npz artifacts with the
PyTorch port's t7 reader — counterpart of
``fast_artistic_videos_tpu/cli/import_t7.py``. Numpy only: it needs no card.

  python -m fast_artistic_videos_tpu_torch.cli.import_t7 model checkpoint-candy-video.t7 candy-video.npz
  python -m fast_artistic_videos_tpu_torch.cli.import_t7 vgg vgg16.t7 vgg16.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import t7


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["model", "vgg"])
    p.add_argument("t7_path")
    p.add_argument("out_path")
    args = p.parse_args(argv)
    if args.kind == "model":
        t7.convert_model_file(args.t7_path, args.out_path)
    else:
        params = t7.import_vgg16(t7.load_t7(args.t7_path))
        flat = {}
        for layer, leaves in params.items():
            for k, v in leaves.items():
                flat[f"{layer}/{k}"] = np.asarray(v)
        np.savez(args.out_path, **flat)
    print(f"wrote {args.out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
