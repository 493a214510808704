"""Accuracy of kernel K3 in bfloat16 and of its plain version (cuDNN's bf16
conv) against a float64 conv of the same bfloat16 values, on a CUDA card.

  python3 tools/front_accuracy.py        # from the repository root

For the front's shapes at two ragged sizes and at 1080p: relative L2 of y
and the statistics error as the instance norm reads them (the mean's error
in units of the channel's std, the variance's relative error), for the
kernel and for the plain version, each against the float64 conv, and the
kernel against the plain version. The inputs are those of
tests/test_torch_kernels_gpu.py's K3 test with an unscaled affine bias.
"""

import os
import sys

SHAPES = [(9, 1, 4, 7, 32), (9, 1, 4, 3, 64), (3, 2, 1, 32, 64), (3, 2, 1, 64, 128),
          (3, 2, 1, 96, 128), (3, 2, 1, 128, 64)]          # (k, stride, pad, cin, cout)


def _stats_err(got, want, count):
    m, mp = got[0] / count, want[0] / count
    v, vp = got[1] / count - m * m, want[1] / count - mp * mp
    return max(((m - mp).abs() / vp.clamp(min=1e-12).sqrt()).max().item(),
               ((v - vp).abs() / vp.clamp(min=1e-12)).max().item())


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from fast_artistic_videos_tpu_torch.ops import _conv_in, front_kernel

    if not torch.cuda.is_available():
        print("front_accuracy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False

    def stats(t):
        return torch.stack([t.sum((0, 1)), (t * t).sum((0, 1))])

    for h, w in ((52, 68), (37, 45), (1160, 2000)):
        for k, s, p, cin, cout in SHAPES:
            if h > 100 and cin > 32:
                continue
            rng = np.random.default_rng(3)
            x = torch.from_numpy(rng.standard_normal((h, w, cin))).float().cuda().bfloat16()
            wt = torch.from_numpy(rng.standard_normal((cout, cin, k, k))
                                  / np.sqrt(k * k * cin)).float().cuda()
            b = torch.from_numpy(rng.standard_normal(cout) * 0.1).float().cuda()
            eff = torch.from_numpy(np.stack([rng.random(cin) + 0.5,
                                             rng.standard_normal(cin)])).float().cuda()
            got = front_kernel.same_conv(x, wt, b, s, p, eff=eff, relu=True)
            want = front_kernel.same_conv_plain(x, wt, b, s, p, eff=eff, relu=True)
            a = _conv_in._prologue(x, eff, True, None).double()
            ref = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], wt.bfloat16().double(),
                                             b.bfloat16().double(), s, p)[0].permute(1, 2, 0)
            n = ref.shape[0] * ref.shape[1]

            def rel(y):
                return ((y.double() - ref).norm() / ref.norm()).item()
            print(f"{(h, w, k, cin, cout)}: vs float64: kernel rel {rel(got[0]):.3g} stats "
                  f"{_stats_err(got[1].double(), stats(ref), n):.3g}; plain (cuDNN) rel "
                  f"{rel(want[0]):.3g} stats {_stats_err(want[1].double(), stats(ref), n):.3g}; "
                  f"kernel vs plain stats {_stats_err(got[1], want[1], n):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
