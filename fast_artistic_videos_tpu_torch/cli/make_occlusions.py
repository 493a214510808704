"""CLI: run the flow-consistency check over every forward/backward pair in
every scene's flow directory with the PyTorch port — counterpart of
``fast_artistic_videos_tpu/cli/make_occlusions.py`` (the reference's
video_dataset/make_occlusions.sh, :20-39), with ``--device`` (default
``cuda``; there is no silent fallback to the CPU).

Expects per scene: <scene>/flow/{s_,}<i>_<j>.flo pairs (forward i->j and
backward j->i named <j>_<i>.flo); writes reliable_<i>_<j>.pgm next to them.
Uses the port's check (``flow.consistency``) by default, or the shared C++
binary (tools/consistencyChecker) with --native.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess

import torch

from ..core import device as device_mod
from ..core import io
from ..flow import consistency

_FLO = re.compile(r"^(s_)?(\d+)_(\d+)\.flo$")


def check_pair(flow_dir: str, prefix: str, i: int, j: int, native: str = "",
               device=device_mod.DEFAULT) -> bool:
    fwd = os.path.join(flow_dir, f"{prefix}{i}_{j}.flo")
    bwd = os.path.join(flow_dir, f"{prefix}{j}_{i}.flo")
    out = os.path.join(flow_dir, f"reliable_{prefix}{i}_{j}.pgm")
    if not (os.path.exists(fwd) and os.path.exists(bwd)):
        return False
    if native:
        subprocess.run([native, fwd, bwd, out], check=True)
        return True
    dev = device_mod.resolve(device)
    mask = consistency.consistency_mask(torch.from_numpy(io.read_flo(fwd)).to(dev),
                                        torch.from_numpy(io.read_flo(bwd)).to(dev))
    io.write_pgm(out, (mask * 255.0).cpu().numpy())
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir", help="directory of scene dirs with flow/ subdirs")
    p.add_argument("--native", default="",
                   help="path to the consistency_checker binary (uses the port's check otherwise)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the port's check: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    device = None if args.native else device_mod.resolve(args.device)
    count = 0
    for scene in sorted(os.listdir(args.input_dir)):
        flow_dir = os.path.join(args.input_dir, scene, "flow")
        if not os.path.isdir(flow_dir):
            continue
        seen = set()
        for name in sorted(os.listdir(flow_dir)):
            m = _FLO.match(name)
            if not m:
                continue
            prefix, i, j = m.group(1) or "", int(m.group(2)), int(m.group(3))
            key = (prefix, min(i, j), max(i, j))
            if key in seen:
                continue
            seen.add(key)
            if check_pair(flow_dir, prefix, i, j, args.native, device):
                count += 1
            if check_pair(flow_dir, prefix, j, i, args.native, device):
                count += 1
    print(f"{count} reliability maps written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
