"""Time kernel K3's three float32 layers (the stylizer front at 1080p) on a
CUDA card, for the checkout in the current directory.

  python3 tools/time_front_f32.py LABEL             # from the repository root
  cd other_checkout && python3 /path/to/tools/time_front_f32.py LABEL

Each layer runs through the public wrapper (front_kernel.same_conv), so it
times whichever C entry the checkout routes the float32 front to:
fav_front_f32 (front_f32.cu) from the tree that added it on, fav_conv_in
(conv_in.cu) before it. For each layer: the entry taken, the kernel against
its plain version (relative L2 of y and of the statistics), its time on
CUDA events (median of 20), its device time (torch.profiler, mean of 20),
cuDNN's float32 conv (TF32 off) on the same data, and the bound, with
chip_smoke.py's timers. Comparing two checkouts means running this in
each, on one card, in turns (A, B, B, A): event times drift between runs.
"""

import os
import sys

LAYERS = [  # (h, w, cin, cout, k, stride, pad, prologue): 1080p after the 40-px pad
    (1160, 2000, 7, 32, 9, 1, 4, False),
    (1160, 2000, 32, 64, 3, 2, 1, True),
    (580, 1000, 64, 128, 3, 2, 1, True),
]
SYMBOLS = {"fav_conv_in": "conv_in_kernel", "fav_front_f32": "front_f32_"}


def main(label: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.ops import front_kernel

    if not torch.cuda.is_available():
        print("time_front_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(cs._nvidia_smi(), flush=True)
    g = torch.Generator(device="cpu").manual_seed(1)
    k3 = front_kernel.KERNEL
    for i, (h, w, cin, cout, k, s, p, prologue) in enumerate(LAYERS):
        x = torch.randn(h, w, cin, generator=g).cuda()
        wt = (torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        eff = (torch.stack([torch.rand(cin, generator=g) + 0.5,
                            torch.randn(cin, generator=g) * 0.1]).cuda() if prologue else None)

        def run():
            return front_kernel.same_conv(x, wt, b, s, p, eff=eff, relu=prologue)
        before = dict(k3.routes)
        got = run()
        entry = next(e for e, n in k3.routes.items() if n != before.get(e, 0))
        want = front_kernel.same_conv_plain(x, wt, b, s, p, eff=eff, relu=prologue)
        rel = max(((a - r).norm() / r.norm()).item() for a, r in zip(got, want))
        ms = cs._time_ms(torch, run)
        dev = cs._profile_ms(torch, run, SYMBOLS[entry])
        xc = x.permute(2, 0, 1)[None]
        lib = cs._time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wt, b, s, p))
        flops = 2 * got[0].numel() * cin * k * k
        b_ms, b_by = cs.bound((x.numel() + got[0].numel() + wt.numel()) * 4, flops, "float32")
        print(f"{label} layer {i} ({h},{w},{cin})->{cout} k{k} s{s} via {entry}: rel {rel:.3g} "
              f"events {ms:.4f} ms device {dev:.4f} ms conv2d {lib:.4f} ms bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.1f} GFLOP; device at {flops / dev / 1e9:.1f} TFLOP/s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
