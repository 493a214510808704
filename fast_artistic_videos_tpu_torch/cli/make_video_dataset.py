"""CLI: pack frame / flow / certainty tuples into the training HDF5 —
counterpart of ``fast_artistic_videos_tpu/cli/make_video_dataset.py`` (the
reference's video_dataset/make_video_dataset.py).

Layout (the reference's, :70-80, read by ``train.data.H5VideoSource``):
  /{train,val}/frames1  (N, seq, 3, H, W)  uint8
  /{train,val}/flow     (N, seq-1, 2, H, W) float32   (u, v) channels
  /{train,val}/cert     (N, seq-1, H, W)   uint8

Tuples start at the ``s_<i>_<j>.flo`` markers in each scene's flow
directory (make_video_dataset.py:56-62); frames are ``frame_%05d.ppm``,
flows ``[s_]<i>_<i+1>.flo`` and certainties ``reliable_[s_]<i>_<i+1>.pgm``,
read through ``core.io``. Tuples are shuffled, resized (bilinear,
antialiased when shrinking; flow rescaled to the new size) on ``--device``
(the card unless ``--device cpu`` is given) and split into train and val.

  python -m fast_artistic_videos_tpu_torch.cli.make_video_dataset \\
      --input_dir scenes --output_file video.h5 --height 256 --width 384
"""

from __future__ import annotations

import argparse
import os
import random
import re

import numpy as np

from ..core import device as device_mod
from ..core import io
from .make_image_dataset import resize

_START = re.compile(r"^s_(\d+)_(\d+)\.flo$")


def collect_tuples(input_dir: str):
    tuples = []
    for scene in sorted(os.listdir(input_dir)):
        flow_dir = os.path.join(input_dir, scene, "flow")
        if not os.path.isdir(flow_dir):
            continue
        for name in os.listdir(flow_dir):
            m = _START.match(name)
            if m and int(m.group(1)) < int(m.group(2)):
                tuples.append((os.path.join(input_dir, scene), int(m.group(1))))
    return tuples


def load_tuple(scene_dir: str, start: int, seq: int, h: int, w: int, device):
    frames, flows, certs = [], [], []
    for k in range(seq):
        idx = start + k
        frame = io.load_image(os.path.join(scene_dir, f"frame_{idx:05d}.ppm"))
        fh, fw = frame.shape[:2]
        frames.append(resize(frame, h, w, device))
        if k < seq - 1:
            prefix = "s_" if k == 0 else ""
            flow = resize(io.read_flo(
                os.path.join(scene_dir, "flow", f"{prefix}{idx}_{idx + 1}.flo")), h, w, device)
            flow = np.array(flow, np.float32)
            flow[..., 0] *= w / fw   # flow in pixels of the new size
            flow[..., 1] *= h / fh
            flows.append(flow)
            cert = io.load_image(
                os.path.join(scene_dir, "flow", f"reliable_{prefix}{idx}_{idx + 1}.pgm"),
                num_channels=1)[..., 0]
            certs.append(resize(cert, h, w, device))
    return frames, flows, certs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_file", default="video.h5")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--sequence_length", type=int, default=2)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--val_fraction", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=device_mod.DEFAULT,
                   help="torch device of the resizes (default cuda)")
    args = p.parse_args(argv)
    device = device_mod.resolve(args.device)

    import h5py

    tuples = collect_tuples(args.input_dir)
    random.Random(args.seed).shuffle(tuples)
    if args.max_images > 0:
        tuples = tuples[: args.max_images]
    if not tuples:
        raise SystemExit("no s_*.flo sequence markers found")
    n_val = max(1, int(len(tuples) * args.val_fraction)) if len(tuples) > 1 else 0
    splits = {"train": tuples[n_val:], "val": tuples[:n_val]}
    seq, h, w = args.sequence_length, args.height, args.width

    with h5py.File(args.output_file, "w") as f:
        for split, items in splits.items():
            if not items:
                continue
            n = len(items)
            d_frames = f.create_dataset(f"/{split}/frames1", (n, seq, 3, h, w), np.uint8)
            d_flow = f.create_dataset(f"/{split}/flow", (n, seq - 1, 2, h, w), np.float32)
            d_cert = f.create_dataset(f"/{split}/cert", (n, seq - 1, h, w), np.uint8)
            for idx, (scene, start) in enumerate(items):
                frames, flows, certs = load_tuple(scene, start, seq, h, w, device)
                d_frames[idx] = np.stack(
                    [np.clip(fr * 255, 0, 255).astype(np.uint8).transpose(2, 0, 1)
                     for fr in frames])
                d_flow[idx] = np.stack([fl.transpose(2, 0, 1) for fl in flows])
                d_cert[idx] = np.stack(
                    [np.clip(c * 255, 0, 255).astype(np.uint8) for c in certs])
            print(f"{split}: {n} tuples")
    print(f"wrote {args.output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
