"""Time kernel K1 (the banded warp) on a CUDA card at the main paths'
shapes, for the checkout in the current directory.

  python3 tools/time_warp_banded.py LABEL [SHAPES.json]   # from the repository root
  cd other_checkout && python3 /path/to/tools/time_warp_banded.py LABEL

For each (shape, dtype, band), on a seeded random flow (uniform up to 1.2 x
band per pixel: its taps scatter over the whole band) and on a smooth one
(sines of periods near 100 pixels, amplitude 0.6 x band: neighbouring
pixels' taps lie together, as an optical flow's do): the kernel's device
time (torch.profiler, mean of 20 launches) and its time on CUDA events (median of 20,
chip_smoke.py's timer), its bound (each input read once, each output
written once, at the H100's published 3.35 TB/s), its error against the
plain version, and the host microseconds of one whole call (200 calls
without a synchronisation). The shapes are those of SHAPES.json when given
(a JSON list of [shape, dtype, band]), else the list below: the 2D path at
1080p with flow at half resolution (the engine's prior warp, the flow
pyramid's feature warps, the consistency sample, the reuse delta warp) and
the VR path at 922-px faces (the temporal warp, the six faces' batched
feature warps, the consistency sample). It uses only warp_kernel's
warp_banded and warp_banded_plain, so it runs in older checkouts too:
compare two on one card in turns (A, B, B, A).
"""

import json
import os
import sys
import time

SHAPES = [
    ((1, 1080, 1920, 3), "float32", 16), ((1, 1080, 1920, 3), "bfloat16", 16),
    ((1, 272, 480, 16), "float32", 8), ((1, 136, 240, 32), "float32", 8),
    ((1, 68, 120, 64), "float32", 8), ((1, 34, 60, 96), "float32", 8),
    ((1, 540, 960, 2), "float32", 32), ((1, 270, 480, 128), "float32", 8),
    ((1, 922, 922, 3), "float32", 16), ((1, 922, 922, 3), "bfloat16", 16),
    ((6, 232, 232, 16), "float32", 8), ((6, 116, 116, 32), "float32", 8),
    ((6, 58, 58, 64), "float32", 8), ((1, 461, 461, 2), "float32", 32),
]


def main(label: str, shapes_path: str = None) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    if not torch.cuda.is_available():
        print("time_warp_banded: no CUDA device", file=sys.stderr)
        return 2
    print(cs._nvidia_smi(), flush=True)
    shapes = SHAPES
    if shapes_path:
        with open(shapes_path) as f:
            shapes = [(tuple(s), d, b) for s, d, b in json.load(f)]
    g = torch.Generator(device="cpu").manual_seed(5)
    rows = []
    for shape, dname, band in shapes:
        dtype = getattr(torch, dname)
        img = torch.rand(shape, generator=g).to("cuda", dtype)
        n, h, w = shape[:3]
        ys = torch.arange(h, dtype=torch.float32).view(h, 1)
        xs = torch.arange(w, dtype=torch.float32).view(1, w)
        smooth = torch.stack([torch.sin(2 * torch.pi * (xs / 97 + ys / 131)),
                              torch.cos(2 * torch.pi * (xs / 113 - ys / 89))], -1)
        flows = {"random": (torch.rand((n, h, w, 2), generator=g) * 2 - 1) * band * 1.2,
                 "smooth": (smooth * band * 0.6).expand(n, h, w, 2).contiguous()}
        for kind, f in flows.items():
            rows.append(time_case(torch, cs, warp_kernel, label, shape, dname, band, img,
                                  f.cuda(), kind))
    print(json.dumps({"time_warp_banded": rows}), flush=True)
    return 0


def time_case(torch, cs, warp_kernel, label, shape, dname, band, img, flow, kind):
    def call():
        return warp_kernel.warp_banded(img, flow, band)
    err = (call().float() - warp_kernel.warp_banded_plain(img, flow, band).float()
           ).abs().max().item()
    try:
        dev_ms = cs._profile_ms(torch, call, "warp_banded", tries=5)
    except RuntimeError as e:      # no device time rather than a made-up one
        print(f"{label} K1 {tuple(shape)}: {e}", flush=True)
        dev_ms = float("nan")
    ev_ms = cs._time_ms(torch, call)
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    nel = img.numel()
    b_ms = (2 * nel * img.element_size() + flow.numel() * 4) / cs.PEAK_BYTES_S * 1e3
    print(f"{label} K1 {tuple(shape)} {dname} band {band} {kind} flow: device "
          f"{dev_ms:.4f} ms, events {ev_ms:.4f} ms, host {host_us:.1f} us per call, bound "
          f"{b_ms:.4f} ms (bytes; device at {b_ms / dev_ms:.0%}), max_abs_err {err:.3g}",
          flush=True)
    return dict(label=label, shape=list(shape), dtype=dname, band=band, flow=kind,
                device_ms=dev_ms, ms=ev_ms, host_us=host_us, bound_ms=b_ms, err=err)


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]) if len(sys.argv) > 1 else main("run"))
