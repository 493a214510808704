"""Drive the PyTorch port (fast_artistic_videos_tpu_torch) once on a CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line is printed):

  1. the device, torch and CUDA versions, and the card's name and power
     limit as nvidia-smi reports them;
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the shapes the 1080p
     main path gives it (kernel and plain times: CUDA events, median of 20);
  4. the main path: the streaming 2D stylizer (bundled demo model, bundled
     flow estimator, flow at half resolution) on 12 seeded 1080p pan
     frames, float32 then bfloat16, through the CLI's build functions and
     VideoDriver.run; the launch counters must rise by the expected amount
     per frame and every output must be finite;
  5. the port on the card against the JAX package's committed CLI output
     (tests/fixtures/torch_parity_demo.npz), mean-abs <= 1e-2 per frame.

The last two lines of standard output are a JSON line per kernel set
(name, route, source, the TPU kernel it replaces, launches in the float32
main-path run, max abs error, kernel and plain milliseconds) and
{"ok": true, "device": {...}}. float32 runs with TF32 off.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES_1080 = 12
SIZE_1080 = (1080, 1920)
PAN_1080 = (6, 3)          # (dx, dy) pixels per frame


def log(*a):
    print(*a, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def _time_ms(torch, fn, n=20):
    """Median of n timed calls (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def pan_frames(seed, n, h, w, step):
    """n uint8 (h, w, 3) frames of a smooth random texture panned by
    step = (dx, dy) pixels per frame (a backward flow of exactly step)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sx, sy = step
    canvas = rng.random((h + n * sy + 16, w + n * sx + 16, 3), dtype=np.float32)
    for _ in range(2):                       # 9x9 box blur, twice
        c = np.pad(np.cumsum(np.cumsum(canvas, 0, dtype=np.float64), 1),
                   ((1, 0), (1, 0), (0, 0)))
        canvas = ((c[9:, 9:] - c[:-9, 9:] - c[9:, :-9] + c[:-9, :-9]) / 81.0).astype(np.float32)
    canvas = (canvas - canvas.min()) / (canvas.max() - canvas.min())
    u8 = np.round(canvas * 255).astype(np.uint8)
    return np.stack([u8[t * sy:t * sy + h, t * sx:t * sx + w] for t in range(n)])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch):
    from fast_artistic_videos_tpu_torch.ops import _conv_in, front_kernel, rblock_kernel
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    g = torch.Generator(device="cpu").manual_seed(1234)
    dev = "cuda"
    res = {"warp_banded": [], "front_conv": [], "res_chain_conv": []}

    def warp_case(shape, band, dtype, tol):
        img = torch.rand(shape, generator=g).to(dev, dtype)
        flow = ((torch.rand(shape[:3] + (2,), generator=g) * 2 - 1) * band * 1.2).to(dev)
        got = warp_kernel.warp_banded(img, flow, band)
        want = warp_kernel.warp_banded_plain(img, flow, band)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = _time_ms(torch, lambda: warp_kernel.warp_banded(img, flow, band))
        plain_ms = _time_ms(torch, lambda: warp_kernel.warp_banded_plain(img, flow, band))
        log(f"K1 warp {tuple(shape)} band {band} {dtype}: max_abs_err {err:.3g} "
            f"(tol {tol:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"K1 warp {shape} band {band} {dtype}: err {err}")
        res["warp_banded"].append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype))

    f32, bf16 = torch.float32, torch.bfloat16
    warp_case((1, 1080, 1920, 3), 16, f32, 1e-5)       # engine prior warp
    warp_case((1, 1080, 1920, 3), 32, f32, 1e-5)
    warp_case((1, 1080, 1920, 3), 16, bf16, 2 ** -7)
    warp_case((1, 540, 960, 2), 32, f32, 1e-5)         # consistency sample
    warp_case((1, 540, 960, 2), 16, f32, 1e-5)
    for shape in ((1, 272, 480, 16), (1, 136, 240, 32), (1, 68, 120, 64), (1, 34, 60, 96)):
        warp_case(shape, 8, f32, 1e-5)                  # estimator feature warps
    warp_case((1, 136, 240, 32), 8, bf16, 2 ** -7)

    def conv_case(kernel, h, w, cin, cout, k, stride, pad, eff, relu, skip, emit, dtype):
        x = torch.randn(h, w, cin, generator=g).to(dev, dtype)
        wt = (torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=g) * 0.1).to(dev)
        e = None
        if eff:
            e = torch.stack([torch.rand(cin, generator=g) + 0.5,
                             torch.randn(cin, generator=g) * 0.1]).to(dev)
        s = torch.randn(h + 4, w + 4, cin, generator=g).to(dev, dtype) if skip else None
        kw = dict(stride=stride, pad=pad, eff=e, relu=relu, skip=s, emit_input=emit)
        got = _conv_in.conv_in(kernel, x, wt, b, **kw)
        want = _conv_in.conv_in_plain(x, wt, b, **kw)
        torch.cuda.synchronize()
        y, yp = got[0].float(), want[0].float()
        rel = ((y - yp).norm() / yp.norm()).item()
        # statistics as the instance norm reads them: mean error in units of
        # the channel's std, and the variance's relative error
        cnt = y.shape[0] * y.shape[1]
        m, mp = got[1][0] / cnt, want[1][0] / cnt
        v, vp = got[1][1] / cnt - m * m, want[1][1] / cnt - mp * mp
        st = max(((m - mp).abs() / vp.clamp(min=1e-12).sqrt()).max().item(),
                 ((v - vp).abs() / vp.clamp(min=1e-12)).max().item())
        a_err = 0.0
        if emit:   # the prologue result, relative to its own scale
            a_err = ((got[2].float() - want[2].float()).abs().max()
                     / want[2].float().abs().max().clamp(min=1.0)).item()
        err = (y - yp).abs().max().item()
        tol = 1e-4 if dtype == f32 else 1e-2
        ms = _time_ms(torch, lambda: _conv_in.conv_in(kernel, x, wt, b, **kw))
        plain_ms = _time_ms(torch, lambda: _conv_in.conv_in_plain(x, wt, b, **kw))
        log(f"{kernel.name} ({h},{w},{cin})->{cout} k{k} s{stride} p{pad} eff={eff} "
            f"relu={relu} skip={skip} emit={emit} {dtype}: rel_l2 {rel:.3g} "
            f"stats {st:.3g} emit_err {a_err:.3g} max_abs {err:.3g} (tol {tol:g}) "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        if not (rel <= tol and st <= tol and a_err <= tol):
            raise AssertionError(f"{kernel.name} mismatch: rel {rel} stats {st} a {a_err}")
        res[kernel.name].append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype))

    K3, K2 = front_kernel.KERNEL, rblock_kernel.KERNEL
    for dtype in (f32, bf16):
        # the demo model's front at 1080p (after the 40 px reflect pad)
        conv_case(K3, 1160, 2000, 7, 32, 9, 1, 4, False, False, False, False, dtype)
        conv_case(K3, 1160, 2000, 32, 64, 3, 2, 1, True, True, False, False, dtype)
        conv_case(K3, 580, 1000, 64, 128, 3, 2, 1, True, True, False, False, dtype)
        # the residual chain: first block's conv1 (fused front norm), a
        # conv2, and a later block's conv1 with the residual add
        conv_case(K2, 290, 500, 128, 128, 3, 1, 0, True, True, False, True, dtype)
        conv_case(K2, 288, 498, 128, 128, 3, 1, 0, True, True, False, False, dtype)
        conv_case(K2, 282, 492, 128, 128, 3, 1, 0, True, False, True, True, dtype)
    return res


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _options(pattern, prefix, dtype, frames):
    from fast_artistic_videos_tpu_torch.core import config

    return config.StylizeOptions(input_pattern=pattern, output_prefix=prefix,
                                 model_vid="demo", flow_model="bundled", flow_scale=0.5,
                                 dtype=dtype, num_frames=frames)


def _drive(torch, opt, record=None, write=True):
    """One CLI main-path run through the CLI's build functions; returns
    (results, seconds on CUDA events). write=False skips the PNG encoding
    (the writer thread still downloads every uint8 frame)."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver

    device = cli.resolve_device("cuda")
    engine = cli.build_engine(opt, device)
    provider = cli.build_flow_provider(opt, device)
    if record is not None:
        for name in ("stylize_first", "stylize_next"):
            fn = getattr(engine, name)

            def wrapped(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                record.append(out[0] if isinstance(out, tuple) else out)
                return out
            setattr(engine, name, wrapped)
    driver = VideoDriver(engine, opt, flow_provider=provider)
    if not write:
        driver.save = lambda path, u8: None
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    results = driver.run(progress=False)
    e.record()
    torch.cuda.synchronize()
    return results, s.elapsed_time(e) / 1000.0


def run_main_path(torch, workdir):
    import numpy as np
    from fast_artistic_videos_tpu_torch.core import io
    from fast_artistic_videos_tpu_torch.ops import front_kernel, rblock_kernel, warp_kernel

    kernels = {k.name: k for k in (warp_kernel.KERNEL, rblock_kernel.KERNEL, front_kernel.KERNEL)}
    frames = pan_frames(7, FRAMES_1080, *SIZE_1080, PAN_1080)
    for t, f in enumerate(frames, 1):
        io.write_ppm(os.path.join(workdir, f"frame_{t:05d}.ppm"), f)
    pattern = os.path.join(workdir, "frame_%05d.ppm")
    n = FRAMES_1080
    pairs = n - 1
    # per frame: K3 3 launches (layers 0-2), K2 2 per residual block (5);
    # per pair: K1 once for the engine's prior warp, 3 feature warps per
    # flow direction (pyramid levels 2, 1, 0), once for the consistency
    # check's sample
    expect = {"front_conv": 3 * n, "res_chain_conv": 10 * n, "warp_banded": pairs * (1 + 6 + 1)}
    counted = {}
    fps = {}
    for dtype in ("float32", "bfloat16"):
        prefix = os.path.join(workdir, dtype, "o")
        _drive(torch, _options(pattern, prefix, dtype, 3))     # warm-up, not counted
        for k in kernels.values():
            k.launches = 0
        outs = []
        results, secs = _drive(torch, _options(pattern, prefix, dtype, n), record=outs)
        launches = {name: k.launches for name, k in kernels.items()}
        log(f"main path {dtype}: {len(results)} frames {SIZE_1080} in {secs:.3f} s "
            f"({len(results) / secs:.3f} fps, CUDA events over the whole run), "
            f"launches {launches}, expected {expect}")
        if len(results) != n or launches != expect:
            raise AssertionError(f"main path {dtype}: {len(results)} frames, "
                                 f"launches {launches} != {expect}")
        for o in outs:
            if tuple(o.shape) != SIZE_1080 + (3,) or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"main path {dtype}: bad output {tuple(o.shape)}")
        last = io.load_image_u8(f"{prefix}-{n:05d}.png")
        if last.shape != SIZE_1080 + (3,) or last.std() < 1.0:
            raise AssertionError("main path: the written frame is degenerate")
        counted[dtype] = launches
        fps[dtype] = len(results) / secs
        results, secs = _drive(torch, _options(pattern, prefix, dtype, n), write=False)
        log(f"main path {dtype} without PNG encoding: {len(results) / secs:.3f} fps")
    return counted, fps


def stage_times(torch, workdir):
    """Per-frame device time of the two stages of a steady step at 1080p
    (CUDA events, median of 8): the flow provider on a new frame, and the
    engine's stylize_next. Also the stylizer alone, kernel path against the
    plain (cuDNN) path, whose outputs must agree (deprocessed, /255):
    max-abs 1e-3 in float32, mean-abs 1e-2 in bfloat16."""
    from fast_artistic_videos_tpu_torch.core import io
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer

    device = cli.resolve_device("cuda")
    frames = [torch.from_numpy(io.load_image_u8(os.path.join(workdir, f"frame_{t:05d}.ppm")))
              .to(device) for t in (1, 2)]
    for dtype in ("float32", "bfloat16"):
        opt = _options("", "", dtype, 2)
        engine = cli.build_engine(opt, device)
        provider = cli.build_flow_provider(opt, device)
        provider(frames[0])
        flow, cert = provider(frames[1])
        band = provider.last_band
        prev = engine.stylize_first(frames[0])
        step = [0]

        def next_pair():   # a steady provider step: one pyramid, one pair, the check
            step[0] += 1
            return provider(frames[step[0] % 2])
        t_flow = _time_ms(torch, next_pair, n=8)
        t_eng = _time_ms(torch, lambda: engine.stylize_next(
            frames[1], prev, flow, cert, band, emit_u8=True, pre_eroded=True), n=8)
        spec, params, _ = checkpoint.load_model("demo", device)
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        x = torch.randn(1, 1080, 1920, 7, device=device, dtype=tdt) * 60
        out = {}

        def run(fused):
            out[fused] = stylizer.apply(params, spec, x, fused=fused)
        t_k = _time_ms(torch, lambda: run(True), n=8)
        t_p = _time_ms(torch, lambda: run(False), n=8)
        diff = (out[True].float() - out[False].float()).abs() / 255.0
        err, tol = ((diff.max().item(), 1e-3) if dtype == "float32"
                    else (diff.mean().item(), 1e-2))
        log(f"stages {dtype} 1080p: flow provider {t_flow:.3f} ms/frame, "
            f"engine step {t_eng:.3f} ms (band {band}); stylizer alone "
            f"kernel path {t_k:.3f} ms, plain cuDNN path {t_p:.3f} ms; kernel vs "
            f"plain path {'max' if dtype == 'float32' else 'mean'}-abs/255 {err:.3g} "
            f"(tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"stylizer {dtype} 1080p: kernel path vs plain "
                                 f"path {err} > {tol}")


def check_fixture(torch, workdir):
    import numpy as np
    from fast_artistic_videos_tpu_torch.core import io

    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_demo.npz")) as z:
        frames, want = z["frames"], z["outputs"]
    d = os.path.join(workdir, "fixture")
    os.makedirs(d, exist_ok=True)
    for t, f in enumerate(frames, 1):
        io.write_ppm(os.path.join(d, f"frame_{t:05d}.ppm"), f)
    prefix = os.path.join(d, "out", "o")
    _drive(torch, _options(os.path.join(d, "frame_%05d.ppm"), prefix, "float32",
                           len(frames)))
    got = np.stack([io.load_image_u8(f"{prefix}-{t:05d}.png")
                    for t in range(1, len(frames) + 1)])
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean(axis=(1, 2, 3)) / 255
    log(f"fixture parity (port on the card vs JAX CLI on CPU), mean-abs per frame: "
        f"{[float(e) for e in err]} (tol 1e-2)")
    if got.shape != want.shape or not (err <= 1e-2).all():
        raise AssertionError(f"fixture parity failed: {err}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fast_artistic_videos_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fast_artistic_videos_tpu_torch.ops import _build, front_kernel, rblock_kernel
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    # 1. environment
    smi = _nvidia_smi()
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # 2. build
    t0 = time.monotonic()
    _build.LIBRARY.get(verbose=True)
    log(f"kernels built in {time.monotonic() - t0:.2f} s "
        f"(nvcc {_build.LIBRARY.build_seconds})")
    log(_build.LIBRARY.build_log.strip())
    # 3. kernels
    res = check_kernels(torch)
    with tempfile.TemporaryDirectory() as work:
        # 4. main path; 5. fixture parity
        counted, fps = run_main_path(torch, work)
        stage_times(torch, work)
        check_fixture(torch, work)
    torch.cuda.synchronize()

    rows = []
    for k in (warp_kernel.KERNEL, rblock_kernel.KERNEL, front_kernel.KERNEL):
        cases = res[k.name]
        first = cases[0]              # the first case is the main-path shape in float32
        rows.append({"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": counted["float32"][k.name],
                     "max_abs_err": max(c["err"] for c in cases if c["dtype"] == torch.float32),
                     "ms": first["ms"], "plain_ms": first["plain_ms"]})
    log(f"fps 1080p float32 {fps['float32']:.3f} bfloat16 {fps['bfloat16']:.3f}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.exit(code)
