"""CLI: produce flow (.flo) and reliability (.pgm) files for a frame
sequence with the PyTorch port — counterpart of
``fast_artistic_videos_tpu/cli/make_opt_flow.py`` (the reference's
makeOptFlow_deepflow.sh / makeOptFlow_flownet.sh), with the port's flow
estimator on ``--device`` (default ``cuda``; there is no silent fallback to
the CPU) replacing DeepFlow/FlowNet2.

File contract (makeOptFlow_deepflow.sh:44-64):
  forward_<j>_<i>.flo    flow j -> j+1 (j = i-1)
  backward_<i>_<j>.flo   flow i -> i-1
  reliable_<i>_<j>.pgm   consistency of backward vs forward, structure from frame i
  reliable_<j>_<i>.pgm   consistency of forward vs backward, structure from frame j

Can run concurrently with the stylizer (which polls for the files, exactly
like the reference shell pipeline). Example:

  python -m fast_artistic_videos_tpu_torch.cli.make_opt_flow \\
      --input_pattern frames/frame_%05d.ppm --out_dir flow --flow_model bundled
"""

from __future__ import annotations

import argparse
import os

import torch

from ..core import device as device_mod
from ..core import io
from ..flow import consistency, family


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_pattern", required=True,
                   help="frame filename pattern, e.g. frames/frame_%%05d.ppm")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--flow_model", default="", help="estimator weights (.npz) or 'bundled'")
    p.add_argument("--flow_cmd", default="",
                   help="external flow estimator command with {a} {b} {out} "
                        "placeholders (the run-deepflow.sh / "
                        "run-flownet-multiple.sh adapter slot), e.g. "
                        "'deepflow2 {a} {b} {out}'")
    p.add_argument("--start", type=int, default=1)
    p.add_argument("--no_structure", action="store_true",
                   help="skip the structure-tensor term of the consistency check")
    p.add_argument("--skip_existing", action="store_true", default=True)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    if not args.flow_model and not args.flow_cmd:
        p.error("need --flow_model (the port's estimator) or --flow_cmd (external estimator)")
    device = device_mod.resolve(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.flow_cmd:
        import shlex
        import subprocess

        def compute_flow(path_a, path_b, out_path):
            cmd = [part.format(a=path_a, b=path_b, out=out_path)
                   for part in shlex.split(args.flow_cmd)]
            subprocess.run(cmd, check=True)
            return torch.from_numpy(io.read_flo(out_path)).to(device)

        est = None
    else:
        est = family.load_estimator(args.flow_model, device=device)

    def load(path):
        return torch.from_numpy(io.load_image(path)).to(device)

    def cert(flow1, flow2, image):
        mask = consistency.consistency_mask(flow1, flow2,
                                            None if args.no_structure else image)
        return (mask * 255.0).cpu().numpy()

    i = args.start + 1
    prev = load(args.input_pattern % args.start) \
        if os.path.exists(args.input_pattern % args.start) else None
    prev_feats = None  # cached pyramid of `prev` (estimator path)
    count = 0
    while prev is not None:
        path = args.input_pattern % i
        if not os.path.exists(path):
            break
        cur = load(path)
        cur_feats = None
        j = i - 1
        fwd_name = os.path.join(args.out_dir, f"forward_{j}_{i}.flo")
        bwd_name = os.path.join(args.out_dir, f"backward_{i}_{j}.flo")
        rel_ij = os.path.join(args.out_dir, f"reliable_{i}_{j}.pgm")
        rel_ji = os.path.join(args.out_dir, f"reliable_{j}_{i}.pgm")
        if not (args.skip_existing and all(
            os.path.exists(f) for f in (fwd_name, bwd_name, rel_ij, rel_ji)
        )):
            if est is None:
                forward = compute_flow(args.input_pattern % j,
                                       args.input_pattern % i, fwd_name)
                backward = compute_flow(args.input_pattern % i,
                                        args.input_pattern % j, bwd_name)
            else:
                # each frame's pyramid is computed once and reused for both
                # directions and the next pair (estimator.prep/refine_pair)
                if prev_feats is None:
                    prev_feats = est.prep(prev)
                cur_feats = est.prep(cur)
                backward, forward, _ = est.refine_pair(cur_feats, prev_feats,
                                                       tuple(cur.shape[:2]))
                io.write_flo(fwd_name, forward.cpu().numpy())
                io.write_flo(bwd_name, backward.cpu().numpy())
            io.write_pgm(rel_ij, cert(backward, forward, cur))
            io.write_pgm(rel_ji, cert(forward, backward, prev))
            count += 1
            print(f"pair {j}->{i} done")
        prev = cur
        prev_feats = cur_feats
        i += 1
    print(f"{count} pairs computed in {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
