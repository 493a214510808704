"""Continue flow weights on a harder curriculum with the PyTorch port:
bigger shifts and more occluding piecewise motion at a reduced learning
rate (``flow.train.train_flow_synthetic``), the held-out protocols
evaluated before and after on procedural and natural images, and the new
weights accepted only when every protocol improves or stays within 2%
(EPE) and 0.02 (pass rate). Exits 0 on accept, 1 on reject; the weights
are written either way.

  python tools/finetune_flow_torch.py --out flow_ft.npz [--iterations 20000] [--device cuda]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fast_artistic_videos_tpu_torch.flow import estimator, train as flow_train  # noqa: E402


def report(tag, results):
    for name, (epe_mean, epe_max, pass_mean, pass_min) in results.items():
        print(f"{tag} {name:14s} EPE {epe_mean:.3f} (max {epe_max:.2f}) "
              f"pass {pass_mean:.3f} (min {pass_min:.3f})", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--max_shift", type=float, default=16.0)
    p.add_argument("--p_discontinuous", type=float, default=0.5)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--natural_frac", type=float, default=0.0,
                   help="share of the training pool drawn from the bundled "
                        "natural-statistics fixtures")
    p.add_argument("--natural_augment", action="store_true",
                   help="photometric jitter and two-crop composites over the natural pool")
    p.add_argument("--context", action="store_true",
                   help="graft the (zero-output) context head onto the weights first")
    p.add_argument("--eval_size", type=int, default=128)
    p.add_argument("--eval_cases", type=int, default=4)
    p.add_argument("--init", default="bundled", help="starting weights (.npz or 'bundled')")
    p.add_argument("--out", required=True, help="output weights (.npz)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    def eval_both(params):
        res = {}
        for tag, src in (("proc", None), ("nat", flow_train.natural_image)):
            for name, v in flow_train.evaluate_heldout(
                    params, size=args.eval_size, n_cases=args.eval_cases,
                    image_source=src).items():
                res[f"{tag}/{name}"] = v
        return res

    params = estimator.load_params(args.init, args.device)
    if args.context:
        gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        params = estimator.add_context(params, gen)
    before = eval_both(params)
    report("before", before)
    params = flow_train.train_flow_synthetic(
        iterations=args.iterations, batch_size=args.batch_size, size=args.size,
        max_shift=args.max_shift, p_discontinuous=args.p_discontinuous,
        learning_rate=args.learning_rate, seed=args.seed, params=params,
        natural_frac=args.natural_frac, natural_augment=args.natural_augment,
        device=args.device)
    after = eval_both(params)
    report("after", after)

    ok = True
    for name in before:
        e0, _, p0, _ = before[name]
        e1, _, p1, _ = after[name]
        if e1 > e0 * 1.02 or p1 < p0 - 0.02:
            print(f"REGRESSION on {name}: EPE {e0:.3f}->{e1:.3f} pass {p0:.3f}->{p1:.3f}",
                  flush=True)
            ok = False
    estimator.save_params(args.out, params)
    print(("ACCEPT " if ok else "REJECT (written for inspection) ") + args.out, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
