"""Time kernels K2 and K4 in float32 at the main path's 1080p shapes on a
CUDA card, for the checkout in the current directory.

  python3 tools/time_conv_f32.py LABEL              # from the repository root
  cd other_checkout && python3 /path/to/tools/time_conv_f32.py LABEL

Each case runs through the public wrappers (rblock_kernel.chain_conv,
conv_kernel.conv3x3_valid), so it times whichever C entry the checkout
routes float32 to: fav_conv3x3_f32 (conv3x3_f32.cu) from this tree on,
fav_conv_in / fav_conv3x3 (conv_in.cu) before it. For each case: the entry
taken, the kernel against its plain version (relative L2), its time on CUDA
events (median of 20), its device time (torch.profiler, mean of 20),
cuDNN's float32 conv (TF32 off) on the same data, and the bound, with
chip_smoke.py's timers. Comparing two checkouts means running this in
each, on one card, in turns (A, B, B, A): event times drift between runs.
"""

import os
import sys

# (n, h, w, eff, relu, skip, emit): K2 is batch 1 with its prologue, K4 the
# batched VALID block conv; 128 -> 128 channels
CASES = [
    ("K2 conv1, block 1", 1, 290, 500, True, True, False, True),
    ("K2 conv2", 1, 288, 498, True, True, False, False),
    ("K2 conv1, skip", 1, 282, 492, True, False, True, True),
    ("K4 batch 4", 4, 290, 500, False, False, False, False),
]
SYMBOLS = {"fav_conv_in": "conv_in_kernel", "fav_conv3x3": "conv_in_kernel",
           "fav_conv3x3_f32": "conv3x3_f32_kernel"}


def main(label: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.ops import conv_kernel, rblock_kernel

    if not torch.cuda.is_available():
        print("time_conv_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(cs._nvidia_smi(), flush=True)
    g = torch.Generator(device="cpu").manual_seed(1)
    c = 128
    for name, n, h, w, eff, relu, skip, emit in CASES:
        x = torch.randn(n, h, w, c, generator=g).cuda()
        wt = (torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5).cuda()
        b = (torch.randn(c, generator=g) * 0.1).cuda()
        kw = dict(eff=torch.stack([torch.rand(c, generator=g) + 0.5,
                                   torch.randn(c, generator=g) * 0.1]).cuda() if eff else None,
                  pre_relu=relu,
                  skip=torch.randn(h + 4, w + 4, c, generator=g).cuda() if skip else None,
                  emit_input=emit)
        if n == 1:
            kern = rblock_kernel.KERNEL

            def run():
                return rblock_kernel.chain_conv(x[0], wt, b, **kw)

            def plain():
                return rblock_kernel.chain_conv_plain(x[0], wt, b, **kw)
        else:
            kern = conv_kernel.KERNEL

            def run():
                return (conv_kernel.conv3x3_valid(x, wt, b),)

            def plain():
                return (conv_kernel.conv3x3_plain(x, wt, b, False, 0),)
        before = dict(kern.routes)
        got, want = run()[0], plain()[0]
        entry = next(e for e, k in kern.routes.items() if k != before.get(e, 0))
        rel = ((got - want).norm() / want.norm()).item()
        ms = cs._time_ms(torch, run)
        dev = cs._profile_ms(torch, run, SYMBOLS[entry])
        xc = x.permute(0, 3, 1, 2)
        lib = cs._time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wt, b))
        flops = 2 * got.numel() * c * 9
        b_ms, b_by = cs.bound((x.numel() + got.numel() + wt.numel()) * 4, flops, "float32")
        print(f"{label} {name} ({n},{h},{w},{c})->{c} via {entry}: rel {rel:.3g} events "
              f"{ms:.4f} ms device {dev:.4f} ms conv2d {lib:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.1f} GFLOP; device at {flops / dev / 1e9:.1f} TFLOP/s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
