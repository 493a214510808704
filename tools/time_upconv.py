"""Time kernel K6 (the folded upsample conv of the stylizer's tail) on a CUDA
card at the canonical net's tail shapes, and the whole stylizer with and
without it.

  python3 tools/time_upconv.py LABEL            # from the repository root

For each tail layer (1080p frames and 922-px cube faces, which the engine
pads to 924): K6 through its wrapper (upconv_kernel.upconv) against its
plain version on the card (relative L2) and against a float64 conv of the
upsampled input (relative L2 of K6 and of cuDNN's float32 conv), K6's time
on CUDA events (median of 20) and its device time (torch.profiler, mean of
20), the plain version's time, cuDNN's float32 conv of the upsampled input
(TF32 off; the route the stylizer took before K6) alone and with the
upsample, norm and ReLU before it, and the bounds by the folded and by the
unfolded operations. Then stylizer.apply on one 1080p frame and one face,
with K6 and with the plan's K6 condition (stylizer.folds_upsample) turned
off (the layer-by-layer tail), in turns: events, the largest difference of
the two outputs, K6's launches per call, and the 8 kernels with the most
device time. The ptxas report of K6's
instances comes first when this call builds the library.
"""

import os
import sys

# (label, low-resolution input (N, H, W, Cin), k, Cout, last layer)
LAYERS = [
    ("1080p layer 9", (1, 270, 480, 128), 3, 64, False),
    ("1080p layer 11", (1, 540, 960, 64), 9, 3, True),
    ("face layer 9", (1, 231, 231, 128), 3, 64, False),
    ("face layer 11", (1, 462, 462, 64), 9, 3, True),
]
SYMBOL = "upconv_f32_kernel"


def _ptxas(build_log: str):
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "upconv" in line:
            yield from lines[i:i + 4]


def main(label: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from fast_artistic_videos_tpu_torch.models import arch_dsl, stylizer
    from fast_artistic_videos_tpu_torch.ops import _build, upconv_kernel

    if not torch.cuda.is_available():
        print("time_upconv: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(cs._nvidia_smi(), torch.__version__, flush=True)
    if not os.path.exists(_build.LIBRARY.path()):
        _build.LIBRARY.get(verbose=True)
        print(f"build {_build.LIBRARY.build_seconds:.1f} s", flush=True)
        for line in _ptxas(_build.LIBRARY.build_log):
            print(line, flush=True)
    g = torch.Generator(device="cpu").manual_seed(1)
    k6 = upconv_kernel.KERNEL
    for name, (n, h, w, cin), k, cout, last in LAYERS:
        x = torch.randn(n, h, w, cin, generator=g).cuda()
        wt = (torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        eff = torch.stack([torch.rand(n, cin, generator=g) + 0.5,
                           torch.randn(n, cin, generator=g) * 0.5], 1).cuda()
        tanh = 150.0 if last else None
        kw = dict(eff=eff, relu=True, stats=not last, tanh_scale=tanh)

        def run():
            return upconv_kernel.upconv(x, wt, b, **kw)
        before = k6.launches
        got = run()
        launches = k6.launches - before
        y = got if last else got[0]
        want = upconv_kernel.upconv_plain(x, wt, b, **kw)
        wy = want if last else want[0]
        rel = ((y - wy).norm() / wy.norm()).item()
        rel_st = 0.0 if last else ((got[1] - want[1]).norm() / want[1].norm()).item()
        a = torch.relu(x * eff[:, 0, None, None, :] + eff[:, 1, None, None, :])
        up = stylizer.upsample_nearest(a, 2).permute(0, 3, 1, 2)
        pad = (k - 1) // 2
        ref = F.conv2d(up.double(), wt.double(), b.double(), 1, pad).permute(0, 2, 3, 1)
        cud = F.conv2d(up, wt, b, 1, pad).permute(0, 2, 3, 1)
        if last:
            ref, cud = torch.tanh(ref) * tanh, torch.tanh(cud) * tanh
        rel64 = ((y.double() - ref).norm() / ref.norm()).item()
        rel64_cudnn = ((cud.double() - ref).norm() / ref.norm()).item()
        del ref, cud
        ms = cs._time_ms(torch, run)
        dev = cs._profile_ms(torch, run, SYMBOL)
        plain = cs._time_ms(torch, lambda: upconv_kernel.upconv_plain(x, wt, b, **kw))
        conv_ms = cs._time_ms(torch, lambda: F.conv2d(up, wt, b, 1, pad))
        norm_p = {"scale": torch.rand(cin, device="cuda"), "bias": torch.zeros(cin, device="cuda")}

        def parent_layer():   # upsample, its norm and ReLU, the conv
            hu = torch.relu(stylizer.instance_norm(stylizer.upsample_nearest(x, 2),
                                                   norm_p["scale"], norm_p["bias"]))
            return stylizer.conv2d(hu, wt, b, 1, pad)
        parent_ms = cs._time_ms(torch, parent_layer)
        del up
        t = upconv_kernel.fold_window(k)[2]
        flops = 2 * n * h * w * 4 * t * t * cin * cout
        flops_unfolded = 2 * n * 4 * h * w * k * k * cin * cout
        nbytes = (x.numel() + y.numel() + wt.numel()) * 4
        b_ms, b_by = cs.bound(nbytes, flops, "float32")
        bu_ms, _ = cs.bound(nbytes, flops_unfolded, "float32")
        print(f"{label} {name} {(n, h, w, cin)}->{cout} k{k}: launches {launches} rel_plain "
              f"{rel:.3g} rel_stats {rel_st:.3g} rel_f64 {rel64:.3g} (cuDNN f32 {rel64_cudnn:.3g}) "
              f"events {ms:.4f} ms device {dev:.4f} ms plain {plain:.4f} ms cuDNN conv "
              f"{conv_ms:.4f} ms parent layer {parent_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e9:.1f} GFLOP folded; device at {flops / dev / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / dev:.1f} %) unfolded bound {bu_ms:.4f} ms "
              f"({flops_unfolded / 1e9:.1f} GFLOP)", flush=True)

    spec = arch_dsl.parse_arch("canonical")
    params = stylizer.init_params(torch.Generator(device="cuda").manual_seed(2), spec,
                                  device="cuda")
    folds = stylizer.folds_upsample
    for name, hw in (("1080p", (1080, 1920)), ("face", (924, 924))):
        x = (torch.randn(1, *hw, 7, generator=g) * 60).cuda()

        def fused():
            with torch.no_grad():
                return stylizer.apply(params, spec, x)

        def layerwise():
            stylizer.folds_upsample = lambda *a: False
            try:
                return fused()
            finally:
                stylizer.folds_upsample = folds
        before = k6.launches
        a = fused()
        launches = k6.launches - before
        diff = (a - layerwise()).abs().max().item()
        times = {"K6": [], "layerwise": []}
        for fn, key in ((fused, "K6"), (layerwise, "layerwise"), (layerwise, "layerwise"),
                        (fused, "K6")):
            times[key].append(cs._time_ms(torch, fn, n=10))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fused()
            torch.cuda.synchronize()
        def dev_us(e):
            t = getattr(e, "self_device_time_total", None)
            return getattr(e, "self_cuda_time_total", 0.0) if t is None else t
        top = sorted(prof.key_averages(), key=lambda e: -dev_us(e))[:8]
        rows = "; ".join(f"{e.key[:60]} {dev_us(e) / 5e3:.3f} ms x{e.count / 5:g}" for e in top)
        print(f"{label} stylizer {name}: K6 launches {launches} max|K6 - layerwise| {diff:.4g} "
              f"events K6 {times['K6']} ms layerwise {times['layerwise']} ms; top device ops "
              f"a call: {rows}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
