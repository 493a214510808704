"""Accuracy of kernels K2 and K4 in float32 (conv3x3_f32.cu) and of cuDNN's
float32 conv (TF32 off, the plain versions) against a float64 conv of the
same float32 values, on a CUDA card.

  python3 tools/conv_f32_accuracy.py        # from the repository root

K2 at two ragged sizes and at 1080p with the full prologue (instance-norm
affine, residual add, emission), K4 at a ragged size (SAME, Cout 256,
ReLU) and the batched 1080p shape (VALID): relative L2 of y and, for K2,
the statistics error as the instance norm reads them (the mean's error in
units of the channel's std, the variance's relative error), for the kernel
and for the plain version, each against the float64 conv.
"""

import os
import sys


def _stats_err(got, want, count):
    m, mp = got[0] / count, want[0] / count
    v, vp = got[1] / count - m * m, want[1] / count - mp * mp
    return max(((m - mp).abs() / vp.clamp(min=1e-12).sqrt()).max().item(),
               ((v - vp).abs() / vp.clamp(min=1e-12)).max().item())


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from fast_artistic_videos_tpu_torch.ops import _conv_in, conv_kernel, rblock_kernel

    if not torch.cuda.is_available():
        print("conv_f32_accuracy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    c = 128

    def rel(y, ref):
        return ((y.double() - ref).norm() / ref.norm()).item()

    def stats(t):
        return torch.stack([t.sum((0, 1)), (t * t).sum((0, 1))])

    for h, w in ((37, 29), (67, 131), (290, 500)):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((h, w, c))).float().cuda()
        wt = torch.from_numpy(rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).float().cuda()
        b = torch.from_numpy(rng.standard_normal(c) * 0.1).float().cuda()
        eff = torch.from_numpy(np.stack([rng.random(c) + 0.5,
                                         rng.standard_normal(c)])).float().cuda()
        skip = torch.from_numpy(rng.standard_normal((h + 4, w + 4, c))).float().cuda()
        kw = dict(eff=eff, skip=skip, emit_input=True)
        got = rblock_kernel.chain_conv(x, wt, b, **kw)
        want = rblock_kernel.chain_conv_plain(x, wt, b, **kw)
        a = _conv_in._prologue(x, eff, False, skip).double()
        ref = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], wt.double(),
                                         b.double())[0].permute(1, 2, 0)
        n = ref.shape[0] * ref.shape[1]
        print(f"K2 ({h},{w},{c})->{c} eff+skip+emit vs float64: kernel rel "
              f"{rel(got[0], ref):.3g} stats {_stats_err(got[1].double(), stats(ref), n):.3g}; "
              f"plain (cuDNN float32) rel {rel(want[0], ref):.3g} stats "
              f"{_stats_err(want[1].double(), stats(ref), n):.3g}; a equal to the plain "
              f"prologue: {bool(torch.equal(got[2], want[2]))}", flush=True)
    for nb, h, w, cout, pad, relu in ((3, 67, 131, 256, 1, True), (4, 290, 500, 128, 0, False)):
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal((nb, h, w, c))).float().cuda()
        wt = torch.from_numpy(rng.standard_normal((cout, c, 3, 3))
                              / np.sqrt(9 * c)).float().cuda()
        b = torch.from_numpy(rng.standard_normal(cout) * 0.1).float().cuda()
        fn = conv_kernel.conv3x3 if pad else conv_kernel.conv3x3_valid
        got = fn(x, wt, b, relu)
        want = conv_kernel.conv3x3_plain(x, wt, b, relu, pad)
        ref = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), wt.double(),
                                         b.double(), 1, pad).permute(0, 2, 3, 1)
        if relu:
            ref = torch.relu(ref)
        print(f"K4 ({nb},{h},{w},{c})->{cout} pad {pad} relu={relu} vs float64: kernel rel "
              f"{rel(got, ref):.3g}; plain (cuDNN float32) rel {rel(want, ref):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
