"""Time the host side of kernel launches on a CUDA card (K5, K1, and K2 /
K4 in bfloat16), for the checkout in the current directory.

  python3 tools/time_launch_path.py LABEL           # from the repository root
  cd other_checkout && python3 /path/to/tools/time_launch_path.py LABEL

At the VR path's shapes (922-px faces, overlap 128), in float32:
  * one single-map K5 call (the left border map): the host time of a whole
    call (StripWarp.__call__) and of Kernel.call alone with the arguments
    built once, each as time.perf_counter over 500 calls without a
    synchronisation (fewer launches than the card's queue holds, so the
    host is never held back by the card), and the difference, the
    wrapper's own share;
  * the VR driver's cross-face blend of six faces (VRDriver.
    blend_other_sides) and its border prior of position 4 (_border_prior),
    whichever launches the checkout makes for them (24 and 4 single-map
    launches plus torch ops before the summing entry, one launch after):
    host time per call as above, and CUDA events per call (median of 20,
    chip_smoke.py's timer).
At the engine's 1080p prior warp: one K1 call, whole and Kernel.call
alone, as for K5.
At the 1080p stylizer's shapes, in bfloat16 on the tensor-core route
(conv_tc.cu): one K2 call (290x500x128 -> 128 with the instance-norm
prologue and the emitted input) and one K4 call (4x290x500x128 -> 128
VALID), host microseconds per whole call over 50 calls without a
synchronisation (the calls' device time stays ahead of the host's) and
CUDA events per call.
Comparing two checkouts means running this in each, on one card, in turns
(A, B, B, A).
"""

import os
import sys
import time
import types


def _host_us(torch, fn, n):
    """Host microseconds per call over n calls without a synchronisation."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main(label: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.ops import _build, strip_warp_kernel
    from fast_artistic_videos_tpu_torch.video import driver_vr

    if not torch.cuda.is_available():
        print("time_launch_path: no CUDA device", file=sys.stderr)
        return 2
    print(cs._nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    f, ov = cs.VR_FACE, cs.VR_OVERLAP
    g = torch.Generator(device="cpu").manual_seed(3)
    opt = driver_vr.VROptions(overlap_pixel_w=ov, overlap_pixel_h=ov)
    driver = driver_vr.VRDriver(types.SimpleNamespace(device=dev), opt)
    faces = [torch.rand((f, f, 3), generator=g).to(dev) for _ in range(6)]
    geo = driver._geometry(faces[0])
    fn = geo.warp_left
    img = faces[0]
    # the single-map launch as StripWarp.kernel builds it, its arguments once
    pix_src, pix_frac, line_src, line_frac = fn.tables(dev)
    y0, y1, x0, x1 = fn.box
    out = torch.empty((1, f, f, 3), device=dev)
    args = [_build.ptr(t) for t in (img, pix_src, pix_frac, line_src, line_frac, out)]
    args += [1, f, f, 3, f, f, y0, x0, y1 - y0, x1 - x0, int(fn.transposed), 0]
    k5 = strip_warp_kernel.KERNEL
    call_us = _host_us(torch, lambda: fn(img), 500)
    launch_us = _host_us(torch, lambda: k5.call("fav_strip_warp", dev, *args), 500)
    print(f"{label} K5 single-map call (left map, {f}x{f}x3 float32): host {call_us:.2f} us "
          f"per call; Kernel.call alone {launch_us:.2f} us; the wrapper's own share "
          f"{call_us - launch_us:.2f} us", flush=True)
    driver.segments = list(faces)
    for name, run in (("cross-face blend", driver.blend_other_sides),
                      ("border prior, position 4", lambda: driver._border_prior(4))):
        k5.reset()
        run()
        launches = k5.launches
        host = _host_us(torch, run, 200)
        ev = cs._time_ms(torch, run)
        print(f"{label} K5 {name}: {launches} K5 launches per call, host {host:.1f} us per "
              f"call, events {ev:.4f} ms", flush=True)
    from fast_artistic_videos_tpu_torch.ops import conv_kernel, rblock_kernel, warp_kernel

    # K1 at the engine's prior warp (1080x1920x3 float32, band 16): the
    # whole call and Kernel.call alone (fav_warp_banded, one pixel a thread;
    # the same C signature in older checkouts)
    img1 = torch.rand((1, 1080, 1920, 3), generator=g).to(dev)
    flow1 = ((torch.rand((1, 1080, 1920, 2), generator=g) * 2 - 1) * 19).to(dev)
    out1 = torch.empty_like(img1)
    k1 = warp_kernel.KERNEL
    args1 = [_build.ptr(t) for t in (img1, flow1, out1)] + [1, 1080, 1920, 3, 16, 0]
    call_us = _host_us(torch, lambda: warp_kernel.warp_banded(img1, flow1, 16), 500)
    launch_us = _host_us(torch, lambda: k1.call("fav_warp_banded", dev, *args1), 500)
    print(f"{label} K1 call (1080x1920x3 float32, band 16): host {call_us:.2f} us per call; "
          f"Kernel.call alone {launch_us:.2f} us; the wrapper's own share "
          f"{call_us - launch_us:.2f} us", flush=True)

    bf = torch.bfloat16
    x = torch.randn(290, 500, 128, generator=g).to(dev, bf)
    x4 = torch.randn(4, 290, 500, 128, generator=g).to(dev, bf)
    wt = (torch.randn(128, 128, 3, 3, generator=g) / 34).to(dev)
    b = (torch.randn(128, generator=g) * 0.1).to(dev)
    eff = torch.stack([torch.rand(128, generator=g) + 0.5,
                       torch.randn(128, generator=g) * 0.1]).to(dev)
    for name, run in (("K2 bf16 290x500x128 -> 128, prologue + emit",
                       lambda: rblock_kernel.chain_conv(x, wt, b, eff=eff, pre_relu=True,
                                                        emit_input=True)),
                      ("K4 bf16 4x290x500x128 -> 128 VALID",
                       lambda: conv_kernel.conv3x3_valid(x4, wt, b))):
        host = _host_us(torch, run, 50)
        ev = cs._time_ms(torch, run)
        print(f"{label} {name}: host {host:.1f} us per call, events {ev:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
