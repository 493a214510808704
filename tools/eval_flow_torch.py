"""Evaluate flow weights on the held-out protocols with the PyTorch port
(``fast_artistic_videos_tpu_torch.flow.train.evaluate_heldout``; see its
docstring for the protocols and metrics), on both image sources:
procedural textures and the bundled natural-statistics fixtures. The
estimator runs on --device (default cuda; its feature warps launch K1).

  python tools/eval_flow_torch.py [--weights bundled] [--size 192] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fast_artistic_videos_tpu_torch.flow import estimator  # noqa: E402
from fast_artistic_videos_tpu_torch.flow.train import (  # noqa: E402
    evaluate_heldout, natural_image, random_texture_image)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", default="bundled", help="estimator .npz or 'bundled'")
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--n_cases", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    params = estimator.load_params(args.weights, args.device)
    for label, source in (("procedural", random_texture_image), ("natural", natural_image)):
        for name, (e_mean, e_max, p_mean, p_min) in evaluate_heldout(
                params, size=args.size, n_cases=args.n_cases, image_source=source).items():
            print(f"{label:10s} {name:8s} EPE mean {e_mean:6.3f} max {e_max:6.3f}   "
                  f"consistency-pass mean {p_mean:5.3f} min {p_min:5.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
