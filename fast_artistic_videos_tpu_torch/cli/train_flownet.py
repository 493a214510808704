"""CLI: train the PWC-lite flow estimator with the PyTorch port on
synthetic warps of a single-image corpus (any MS-COCO-style HDF5, as the
style trainer reads) — counterpart of
``fast_artistic_videos_tpu/cli/train_flownet.py``, plus ``--device``
(default ``cuda``).

  python -m fast_artistic_videos_tpu_torch.cli.train_flownet \\
      --h5_file images.h5 --out flow.npz --iterations 20000
"""

from __future__ import annotations

import argparse

from ..core import device as device_mod
from ..flow import estimator, train as flow_train
from ..train import data as data_mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--h5_file", required=True)
    p.add_argument("--out", required=True, help="output weights (.npz)")
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--size", type=int, default=256,
                   help="training crop (a multiple of the pyramid stride)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--resume", default="", help="resume from weights (.npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=device_mod.DEFAULT,
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)

    src = data_mod.H5ImageSource(args.h5_file, args.batch_size,
                                 out_hw=(args.size, args.size))
    params = estimator.load_params(args.resume, args.device) if args.resume else None
    params = flow_train.train_flow(
        lambda: src.next_images("train"),
        iterations=args.iterations,
        learning_rate=args.learning_rate,
        seed=args.seed,
        params=params,
        device=args.device,
    )
    estimator.save_params(args.out, params)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
