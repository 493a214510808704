"""Time kernel K3's three bfloat16 layers (the stylizer front at 1080p) on a
CUDA card, for the checkout in the current directory.

  python3 tools/time_front_tc.py LABEL              # from the repository root
  cd other_checkout && python3 /path/to/tools/time_front_tc.py LABEL

For each layer: the kernel against its plain version (relative L2), its
time on CUDA events (median of 20) and its device time (torch.profiler,
mean of 20), with chip_smoke.py's timers. Comparing two checkouts means
running this in each, on one card, in turns (A, B, B, A).
"""

import os
import sys

LAYERS = [  # (h, w, cin, cout, k, stride, pad, prologue): 1080p after the 40-px pad
    (1160, 2000, 7, 32, 9, 1, 4, False),
    (1160, 2000, 32, 64, 3, 2, 1, True),
    (580, 1000, 64, 128, 3, 2, 1, True),
]


def main(label: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.ops import _conv_in, front_kernel

    if not torch.cuda.is_available():
        print("time_front_tc: no CUDA device", file=sys.stderr)
        return 2
    print(cs._nvidia_smi(), flush=True)
    g = torch.Generator(device="cpu").manual_seed(1)
    k3 = front_kernel.KERNEL
    for h, w, cin, cout, k, s, p, prologue in LAYERS:
        x = torch.randn(h, w, cin, generator=g).cuda().bfloat16()
        wt = (torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        eff = (torch.stack([torch.rand(cin, generator=g) + 0.5,
                            torch.randn(cin, generator=g) * 0.1]).cuda() if prologue else None)
        kw = dict(stride=s, pad=p, eff=eff, relu=prologue)
        got = _conv_in.conv_in(k3, x, wt, b, **kw)[0].float()
        want = _conv_in.conv_in_plain(x, wt, b, **kw)[0].float()
        rel = ((got - want).norm() / want.norm()).item()
        ms = cs._time_ms(torch, lambda: _conv_in.conv_in(k3, x, wt, b, **kw))
        dev = cs._profile_ms(torch, lambda: _conv_in.conv_in(k3, x, wt, b, **kw),
                             "front_tc_kernel")
        print(f"{label} ({h},{w},{cin})->{cout} k{k}: rel {rel:.3g} events {ms:.4f} ms "
              f"device {dev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
