"""Drive the PyTorch port (fast_artistic_videos_tpu_torch) once on a CUDA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line is printed):

  1. the device, torch and CUDA versions, and the card's name and power
     limit as nvidia-smi reports them;
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a), and count
     the tensor-core instructions (HGMMA / HMMA) in the SASS of conv_tc.cu's
     kernel and of every instantiation of front_tc.cu's (cuobjdump): it
     fails without them, and without HGMMA in front_tc.cu's;
  3. each kernel against its plain PyTorch version at the shapes the main
     paths give it (kernel, plain and library-call times: CUDA events,
     median of 20; the kernel's own device time: torch.profiler), with the
     least time the card could take (bound_ms). K2 and K4 in bfloat16 take
     the tensor-core route of conv_tc.cu, K3's three layers in bfloat16
     that of front_tc.cu (each no slower than conv2d on events); K2 and K4
     in float32 take the register-tiled CUDA-core kernel conv3x3_f32.cu,
     K3 in float32 the register-tiled front kernel front_f32.cu; each case
     checks that its launch took the entry that ops/_conv_in.py's
     conv_route names. K5 also runs its summing entry: the cross-face blend
     of six 922-px faces (and a border prior) in one launch, against its
     plain composition, timed beside the composition the VR driver ran
     before it (24 single-map launches, rotated copies, torch ops) and
     beside the same composition over 24 grid_sample calls. K2 and K4 in
     bfloat16 are bit-identical with their packed weights and rounded bias
     cached and packed afresh, with the host microseconds per call of
     both. K1 takes the C entry ops/warp_kernel.py's warp_route names
     (fav_warp_banded for C <= 4, fav_warp_banded_vec otherwise), each
     case beside grid_sample; after phase 13, K1 also runs at every (shape,
     dtype, band) that phases 4, 6, 9, 11 and 13 launched and this list
     lacks;
  4. the 2D main path: the streaming stylizer (bundled demo model, bundled
     flow estimator, flow at half resolution) on 12 seeded 1080p pan
     frames, float32 then bfloat16, through the CLI's build functions and
     VideoDriver.run; the launch counters must rise by the expected amount
     per frame, every launch must take the C entry that conv_route names
     for its dtype (bfloat16: K2 and K3 on the tensor cores; float32: K2 on
     conv3x3_f32.cu, K3 on front_f32.cu), and every output must be finite;
     fps with and without PNG encoding, and the device's busy share without
     it (torch.profiler). K1's launches of the counted runs of phases 4, 6
     and 9 are recorded by (shape, dtype, band, C entry), in this script
     (warp_kernel.warp_banded wrapped), and the record must sum to K1's
     launch and route counters;
  5. the port on the card against the JAX package's committed 2D CLI output
     (tests/fixtures/torch_parity_demo.npz), mean-abs <= 1e-2 per frame;
  6. the VR main path: the spherical stylizer on 6 frames of six seeded
     922x922 pan faces (overlap 128), float32 then bfloat16, through
     cli/stylize_vr_video.py's build functions and VRDriver.run, with exact
     launch counts (and routes, as in phase 4; K5: one summing launch per
     border prior and per frame's blend, the single-map entry only for the
     geometry's four masks), finite faces, fps with and
     without PNG encoding, stage times, the device's busy share
     (torch.profiler), and one face step through the kernels against the
     plain versions;
  7. the port's VR CLI on the card against the JAX package's committed VR
     CLI output (tests/fixtures/torch_parity_vr.npz), mean-abs <= 1e-2 per
     face;
  8. the batched path: --create_inconsistent --inconsistent_batch 4 on 8 of
     the 1080p pan frames, float32 then bfloat16, with exact launch counts
     (K4 20, the other kernels 0; K4 on the tensor cores in bfloat16, on
     conv3x3_f32.cu in float32),
     finite outputs, fps with and without PNG encoding, and the batched
     frames against the same frames stylized one at a time through K3 and
     K2 (mean-abs <= 1e-2);
  9. feature reuse (--feature_reuse 3) on the 12 pan frames, float32, with
     exact K1/K2/K3 counts and entries (no tensor-core launch), frames 1-2
     within one uint8 step of phase 4's exact run and the reuse frames within
     mean-abs 0.05 of it (the JAX package's bound on how far the reuse
     approximation drifts from the exact run, not a correctness check:
     phase 10 holds the reuse mode against the JAX CLI), fps with and
     without PNG; then --scale_factor 0.5 (outputs at full size, finite);
 10. the port CLI on the card against the JAX package's committed outputs of
     its other modes (tests/fixtures/torch_parity_batch.npz: batched,
     feature reuse, scale 0.5, phase-resident), mean-abs <= 1e-2 per frame;
 11. the 2D --evaluate path: phase 4's 12 frames, float32, through the CLI's
     build functions (build_evaluator too) and VideoDriver.run, with a
     full-width VGG-16 written from a numpy seed, the bundled candy style
     image, and the pan's ground-truth .flo / .pgm files for the temporal
     term: launches as in phase 4 (the evaluator launches no kernel), the
     VGG weights on the card, 3 finite series of 12 and 3 means, and the
     temporal error with the ground-truth flow below the same evaluator's
     with zero flow; the scorer's ms per frame on CUDA events;
 12. the port's evaluators on the card against the JAX evaluators' rows
     (tests/fixtures/torch_parity_eval.npz) on the content frames and
     outputs of the 2D and VR fixtures, rtol 1e-4;
 13. make_opt_flow --device cuda on 6 of the 1080p frames (K1 6 launches a
     pair, finite flows near the pan) and the stylize CLI on its files
     (--flow_pattern / --occlusions_pattern); stylize_vr_video_file
     --frames_dir on 3 seeded 3072x1536 equirect frames at --face_size 768
     (finite, non-degenerate equirect output); the VR --evaluate run at
     phase 6's face size on 2 frames (launches as phase 6's, 7 finite series
     of 12, the scorer's ms per face). K1's launches of phases 11 and 13 are
     recorded by shape as those of phases 4, 6 and 9 are.

The last lines of standard output are the card's name and power limit, a
JSON line with one row per kernel (name, route, source, the TPU kernel it
replaces, its float32 C entry, launches in its main path's float32 run, max
abs error, kernel, device, plain, bound and library-call milliseconds, and
under "bfloat16" the same figures of its bfloat16 form: route, source, C
entry, launches in the bfloat16 run and how many of them took the tensor
cores; K3's row also lists its three layers under "layers", each with its
shape and both dtypes' C entry and figures) and {"ok": true, "device":
{...}}. K5's summing entry has a row of its own ("strip_warp_sum": the
cross-face blend, with the times of the composition it replaced and of the
same composition over grid_sample); K1's row lists its launches by C entry
("routes") and every phase-3 case with its launches on the main paths
("cases"). float32 runs with TF32 off.
"""

from __future__ import annotations

import contextlib
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
VR_FACE, VR_OVERLAP = 922, 128   # 768-px cube edges expanded 1.2x
VR_FRAMES = 6
VR_PAN = (8, 2)
# the card's published peaks (H100 SXM; float32 without tensor cores, since
# float32 runs with TF32 off): the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the rate of its type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the kernels with a tensor-core route (K2, K4, K3): bfloat16 at their shapes;
# the source of each tensor-core C entry, and the kernel symbol the profiler
# and cuobjdump name for each C entry
TC_KERNELS = ("res_chain_conv", "conv3x3", "front_conv")
TC_SOURCES = {"fav_conv_tc": "fast_artistic_videos_tpu_torch/csrc/conv_tc.cu",
              "fav_front_tc": "fast_artistic_videos_tpu_torch/csrc/front_tc.cu"}
SYMBOLS = {"fav_conv_tc": "conv_tc_kernel", "fav_front_tc": "front_tc_kernel",
           "fav_conv_in": "conv_in_kernel", "fav_conv3x3_f32": "conv3x3_f32_kernel",
           "fav_front_f32": "front_f32_", "fav_strip_warp": "strip_warp_kernel",
           "fav_strip_warp_sum": "strip_warp_sum_kernel"}
# the C entry of each kernel by dtype on the stylizer's shapes (K3 and K2 at
# batch 1, K4 at batch > 1), as ops/_conv_in.py's conv_route names them
ENTRIES = {"bfloat16": {"res_chain_conv": "fav_conv_tc", "conv3x3": "fav_conv_tc",
                        "front_conv": "fav_front_tc"},
           "float32": {"res_chain_conv": "fav_conv3x3_f32", "conv3x3": "fav_conv3x3_f32",
                       "front_conv": "fav_front_f32"}}


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


def vr_faces(seed, n, face, step):
    """(n, 6, face, face, 3) uint8: six pan streams, one per cube face, cut
    side by side from one pan 6 faces wide."""
    import numpy as np

    pans = pan_frames(seed, n, face, 6 * face, step)
    return np.stack([np.stack([p[:, k * face:(k + 1) * face] for k in range(6)])
                     for p in pans])


def bound(nbytes, flops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _kernels():
    """{name: Kernel} of every hand-written kernel (K1-K5)."""
    from fast_artistic_videos_tpu_torch.ops import (conv_kernel, front_kernel, rblock_kernel,
                                                    strip_warp_kernel, warp_kernel)

    return {k.name: k for k in (warp_kernel.KERNEL, rblock_kernel.KERNEL, front_kernel.KERNEL,
                                conv_kernel.KERNEL, strip_warp_kernel.KERNEL)}


def _dname(torch, dtype):
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def _reset(kernels):
    for k in kernels.values():
        k.reset()


def _check_routes(kernels, launches, dtype, where):
    """Every K2/K3/K4 launch of the run took the C entry that
    ops/_conv_in.py's rule names at the stylizer's shapes for `dtype`
    (ENTRIES): in bfloat16 the tensor cores, in float32 K2 and K4 the
    register-tiled conv3x3_f32.cu and K3 the general template. Returns the
    tensor-core launches per kernel."""
    from fast_artistic_videos_tpu_torch.ops import _conv_in

    got = {name: dict(k.routes) for name, k in kernels.items() if name in TC_KERNELS}
    want = {name: ({ENTRIES[dtype][name]: launches[name]} if launches[name] else {})
            for name in got}
    log(f"{where} {dtype}: launches by C entry {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{where} {dtype}: launches by C entry {got} != {want}")
    return {name: sum(k.routes.get(e, 0) for e in _conv_in.TC_ENTRIES)
            for name, k in kernels.items()}


class WarpShapes:
    """K1's launches on the main paths (phases 4, 6, 9, 11 and 13) by (shape,
    dtype, band, C entry), and the inputs of the first launch of each, kept
    on the card: phase 3 adds a case for each shape its own list lacks, and times
    K1 on the flows the main paths produced (their taps lie close together)
    beside its seeded random flows (whose taps scatter over the whole band).
    `recording()` wraps warp_kernel.warp_banded, here in the script and not
    in the package, for one run (the flow thread launches too, hence the
    lock); `check` holds that run's record against K1's own counters."""

    def __init__(self):
        import threading

        self.counts, self.inputs, self.run = {}, {}, {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def recording(self):
        from fast_artistic_videos_tpu_torch.ops import warp_kernel

        fn = warp_kernel.warp_banded
        self.run = {}

        def wrapped(img, flow, band):
            if img.device.type == "cuda":
                entry = warp_kernel.warp_route(img.shape[-1], img.dtype,
                                               img.data_ptr() % 16 == 0)[0]
                key = (tuple(img.shape), str(img.dtype).split(".")[-1], int(band), entry)
                with self._lock:
                    self.run[key] = self.run.get(key, 0) + 1
                    if key not in self.inputs:
                        self.inputs[key] = (img.clone(), flow.clone())
            return fn(img, flow, band)
        warp_kernel.warp_banded = wrapped
        try:
            yield self
        finally:
            warp_kernel.warp_banded = fn
            for key, n in self.run.items():
                self.counts[key] = self.counts.get(key, 0) + n

    def check(self, kernel, where):
        """Log the last run's record; raise unless it sums to the kernel's
        launches and its C entries to the kernel's routes."""
        by_entry = {}
        for (_, _, _, entry), n in self.run.items():
            by_entry[entry] = by_entry.get(entry, 0) + n
        for (shape, dtype, band, entry), n in sorted(self.run.items()):
            log(f"K1 shape {where}: {shape} {dtype} band {band} via {entry}: {n} launches")
        if sum(self.run.values()) != kernel.launches or by_entry != kernel.routes:
            raise AssertionError(f"{where}: K1 record {by_entry} != launches {kernel.launches} "
                                 f"by entry {kernel.routes}")


def _host_us(torch, fn, n):
    """Host microseconds per call over n calls without a synchronisation,
    after 5 warm-up calls (tools/time_launch_path.py's timer)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def _profile_ms(torch, fn, name, n=20, tries=3):
    """The kernel's own device time per call (ms): torch.profiler over n
    calls, summed over the kernels whose name contains `name`. Each call
    launches one such kernel; where the profiler kept fewer or more records
    than calls, the mean is taken over the records it kept, and said. A
    profile that kept no record of the kernel is taken again, up to `tries`
    times in all, and then raises: a device time is never made up."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms, count = _device_events(prof, name)
        if count != n:
            log(f"profiler: {count} records of {name} for {n} calls (attempt {attempt})")
        if count:
            return ms / count
    raise RuntimeError(f"profiler kept no record of {name} in {tries} profiles")


def _graph_ms(torch, fn, n=20):
    """Device time per call (ms) where the profiler keeps no record of a
    small kernel: n calls captured in one CUDA graph and replayed back to
    back, with no host work between the launches; CUDA events over a
    replay (median of 10), divided by n. It includes the gap between two
    launches of the graph (about a microsecond)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(torch, graph.replay, n=10) / n


def _profile_total_ms(torch, fn, n=20, tries=3):
    """The device time of every kernel that one call of fn launches (ms):
    torch.profiler over n calls, summed and divided by n; retaken, up to
    `tries` profiles in all, when it kept no record, then raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ms, count = _device_events(prof)
        if count:
            return ms / n
    raise RuntimeError(f"profiler kept no record in {tries} profiles")


def sass_mma_counts(lib_path):
    """{kernel symbol: (HGMMA, HMMA)} of the tensor-core kernels (conv_tc.cu,
    front_tc.cu) in the built library's SASS (cuobjdump)."""
    import re

    from fast_artistic_videos_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts = {}
    for chunk in out.stdout.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if SYMBOLS["fav_conv_tc"] in name or SYMBOLS["fav_front_tc"] in name:
            counts[name] = (len(re.findall(r"\bHGMMA\b", chunk)),
                            len(re.findall(r"\bHMMA\b", chunk)))
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def warp_cases(torch, g, out, shape, band, dtype, tol, inputs=None):
    """One K1 case: the kernel against its plain version on seeded inputs
    (image uniform in [0, 1), flow uniform up to 1.2 x band per pixel, so
    some taps leave the band), or on `inputs` (image, flow) that a main path
    launched it with, with CUDA-event, device (profiler), plain, bound and
    grid_sample times; appended to out."""
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    dev = "cuda"
    if inputs is None:
        img = torch.rand(shape, generator=g).to(dev, dtype)
        flow = ((torch.rand(shape[:3] + (2,), generator=g) * 2 - 1) * band * 1.2).to(dev)
    else:
        img, flow = inputs
    entry, vec = warp_kernel.warp_route(shape[3], dtype, img.data_ptr() % 16 == 0)
    before = warp_kernel.KERNEL.routes.get(entry, 0)
    got = warp_kernel.warp_banded(img, flow, band)
    want = warp_kernel.warp_banded_plain(img, flow, band)
    torch.cuda.synchronize()
    if warp_kernel.KERNEL.routes.get(entry, 0) != before + 1:
        raise AssertionError(f"K1 {shape} {dtype}: the launch did not take {entry}")
    err = (got.float() - want.float()).abs().max().item()
    ms = _time_ms(torch, lambda: warp_kernel.warp_banded(img, flow, band))
    try:
        dev_ms, dev_by = _profile_ms(torch, lambda: warp_kernel.warp_banded(img, flow, band),
                                     "warp_banded", tries=5), "profiler"
    except RuntimeError as e:
        log(f"K1 {tuple(shape)} {dtype}: {e}; device time from a CUDA graph instead")
        dev_ms, dev_by = _graph_ms(torch, lambda: warp_kernel.warp_banded(img, flow, band)), \
            "CUDA graph"
    plain_ms = _time_ms(torch, lambda: warp_kernel.warp_banded_plain(img, flow, band))
    # each input read once (image, flow), the output written once; about
    # 6 multiply-adds per output element
    nel = img.numel()
    b_ms, b_by = bound(2 * nel * img.element_size() + flow.numel() * 4, 12 * nel,
                       _dname(torch, dtype))
    # the yardstick: grid_sample's exact bilinear warp (zero padding,
    # align_corners), which the banded two-pass form approximates
    n, h, w = shape[:3]
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    grid = torch.stack([(xs + flow[..., 0]) * 2 / max(w - 1, 1) - 1,
                        (ys + flow[..., 1]) * 2 / max(h - 1, 1) - 1], -1).to(dtype)
    src = img.permute(0, 3, 1, 2)
    lib_ms = _time_ms(torch, lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros", align_corners=True))
    flows = "random flow" if inputs is None else "main-path flow"
    log(f"K1 warp {tuple(shape)} band {band} {dtype} {flows} via {entry} (vec {vec}): "
        f"max_abs_err "
        f"{err:.3g} (tol {tol:g}) kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}) "
        f"plain {plain_ms:.4f} ms grid_sample {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}); "
        f"device at {b_ms / dev_ms:.0%} of the bound")
    if not err <= tol:
        raise AssertionError(f"K1 warp {shape} band {band} {dtype}: err {err}")
    out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms, entry=entry,
                    shape=list(shape), band=band, flows=flows, device_by=dev_by))


def check_recorded_warps(torch, res, k1):
    """Phase 3, continued after the main paths: K1 at each (shape, dtype,
    band) that phases 4, 6, 9, 11 and 13 launched and phase 3's list lacks, on
    seeded random flows, then at every one of them on the inputs of its
    first launch there."""
    g = torch.Generator(device="cpu").manual_seed(4321)
    have = {(tuple(c["shape"]), _dname(torch, c["dtype"]), c["band"])
            for c in res["warp_banded"]}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for shape, dname, band, _ in sorted(k1.counts):
        if (shape, dname, band) in have:
            continue
        have.add((shape, dname, band))
        warp_cases(torch, g, res["warp_banded"], shape, band, dtypes[dname],
                   1e-5 if dname == "float32" else 2 ** -7)
    for key in sorted(k1.counts):
        shape, dname, band, _ = key
        warp_cases(torch, g, res["warp_banded"], shape, band, dtypes[dname],
                   1e-5 if dname == "float32" else 2 ** -7, inputs=k1.inputs[key])


def check_bf16_packs(torch, g):
    """K2 and K4 in bfloat16 (conv_tc.cu) read their weights packed once and
    their bias rounded once per tensor (ops/_conv_in._packed): at the 1080p
    shapes, the outputs with the cached packs are bit-identical to a launch
    that packs and rounds afresh (the cache attributes cleared), and the
    host microseconds per call of both."""
    from fast_artistic_videos_tpu_torch.ops import conv_kernel, rblock_kernel

    dev = "cuda"
    x = torch.randn(290, 500, 128, generator=g).to(dev, torch.bfloat16)
    x4 = torch.randn(4, 290, 500, 128, generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn(128, 128, 3, 3, generator=g) / 34).to(dev)
    b = (torch.randn(128, generator=g) * 0.1).to(dev)
    eff = torch.stack([torch.rand(128, generator=g) + 0.5,
                       torch.randn(128, generator=g) * 0.1]).to(dev)

    def clear():
        for t, attr in ((wt, "_conv_tc_pack"), (b, "_bias_bfloat16")):
            if hasattr(t, attr):
                delattr(t, attr)
    calls = {"K2": lambda: rblock_kernel.chain_conv(x, wt, b, eff=eff, pre_relu=True,
                                                    emit_input=True),
             "K4": lambda: conv_kernel.conv3x3_valid(x4, wt, b)}
    for name, fn in calls.items():
        fn()
        cached = fn()
        clear()
        fresh = fn()
        torch.cuda.synchronize()
        # y and the emitted input bit for bit; K2's statistics are float32
        # sums by atomics, whose order differs from launch to launch
        cached = cached if isinstance(cached, tuple) else (cached,)
        fresh = fresh if isinstance(fresh, tuple) else (fresh,)
        same = all(torch.equal(cached[i], fresh[i]) for i in range(len(cached)) if i != 1)
        if len(cached) > 1:
            same = same and torch.allclose(cached[1], fresh[1], rtol=1e-5, atol=0)
        us = _host_us(torch, fn, 50)
        us_fresh = _host_us(torch, lambda: (clear(), fn()), 50)
        log(f"{name} bf16 packs: outputs with the cached packs bit-identical to packing afresh "
            f"(statistics within float32 atomics' order, rtol 1e-5): "
            f"{same}; host {us:.1f} us per call with the cache, {us_fresh:.1f} us packing "
            f"afresh (50 calls without a sync)")
        if not same:
            raise AssertionError(f"{name} bf16: the cached packs change the output")


def check_kernels(torch):
    from fast_artistic_videos_tpu_torch.ops import _conv_in, front_kernel, rblock_kernel
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    g = torch.Generator(device="cpu").manual_seed(1234)
    dev = "cuda"
    res = {"warp_banded": [], "front_conv": [], "res_chain_conv": []}

    def warp_case(shape, band, dtype, tol):
        warp_cases(torch, g, res["warp_banded"], shape, band, dtype, tol)

    f32, bf16 = torch.float32, torch.bfloat16
    warp_case((1, 1080, 1920, 3), 16, f32, 1e-5)   # engine prior warp
    warp_case((1, 1080, 1920, 3), 32, f32, 1e-5)
    warp_case((1, 1080, 1920, 3), 16, bf16, 2 ** -7)
    warp_case((1, 540, 960, 2), 32, f32, 1e-5)         # consistency sample
    warp_case((1, 540, 960, 2), 16, f32, 1e-5)
    for shape in ((1, 272, 480, 16), (1, 136, 240, 32), (1, 68, 120, 64), (1, 34, 60, 96)):
        warp_case(shape, 8, f32, 1e-5)                  # estimator feature warps
    warp_case((1, 136, 240, 32), 8, bf16, 2 ** -7)
    # the VR path: a face's temporal warp, the six faces' batched feature warps
    warp_case((1, VR_FACE, VR_FACE, 3), 16, f32, 1e-5)
    warp_case((6, 232, 232, 16), 8, f32, 1e-5)

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
        entry = _conv_in.conv_route(dtype, k, k, stride, pad, cin, cout)
        before = kernel.routes.get(entry, 0)
        got = _conv_in.conv_in(kernel, x, wt, b, **kw)
        want = _conv_in.conv_in_plain(x, wt, b, **kw)
        torch.cuda.synchronize()
        if kernel.routes.get(entry, 0) != before + 1:
            raise AssertionError(f"{kernel.name} {dtype}: the launch did not take {entry}")
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
        dev_ms = _profile_ms(torch, lambda: _conv_in.conv_in(kernel, x, wt, b, **kw),
                             SYMBOLS[entry])
        plain_ms = _time_ms(torch, lambda: _conv_in.conv_in_plain(x, wt, b, **kw))
        # the library yardstick: the convolution alone (cuDNN), without the
        # fused prologue and statistics
        xc, wc, bc = x.permute(2, 0, 1)[None], wt.to(dtype), b.to(dtype)
        lib_ms = _time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, stride, pad))
        esz = x.element_size()
        nbytes = (x.numel() + y.numel() + (s.numel() if skip else 0)
                  + (x.numel() if emit else 0)) * esz + wt.numel() * 4
        b_ms, b_by = bound(nbytes, 2 * y.shape[0] * y.shape[1] * cout * cin * k * k,
                           _dname(torch, dtype))
        shape = f"({h},{w},{cin})->{cout} k{k} s{stride} p{pad}"
        log(f"{kernel.name} {shape} eff={eff} "
            f"relu={relu} skip={skip} emit={emit} {dtype} via {entry}: rel_l2 {rel:.3g} "
            f"stats {st:.3g} emit_err {a_err:.3g} max_abs {err:.3g} (tol {tol:g}) "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, profiler) plain {plain_ms:.4f} ms "
            f"conv2d {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not (rel <= tol and st <= tol and a_err <= tol):
            raise AssertionError(f"{kernel.name} mismatch: rel {rel} stats {st} a {a_err}")
        if entry == _conv_in.FRONT_TC_ENTRY and not lib_ms >= ms:
            raise AssertionError(f"{kernel.name} {shape} {dtype} via {entry}: {ms} ms, "
                                 f"slower than conv2d's {lib_ms} ms")
        res[kernel.name].append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype,
                                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                     device_ms=dev_ms, entry=entry, shape=shape))

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
    res["strip_warp"] = check_strip_warp(torch, g)
    res["strip_warp_sum"] = check_strip_sum(torch, g)
    res["conv3x3"] = check_block_conv(torch, g)
    check_bf16_packs(torch, g)
    return res


def check_block_conv(torch, g):
    """K4 against its plain version: the batched 1080p residual-block conv
    (4, 290, 500, 128) -> 128 VALID in float32 and bfloat16, and a SAME
    (pad 1) conv widening to 256 with the ReLU epilogue. Relative L2
    <= 1e-4 float32, <= 1e-2 bfloat16 (the conv_case tolerances); the
    library yardstick is F.conv2d (cuDNN) on the same NHWC data."""
    from fast_artistic_videos_tpu_torch.ops import _conv_in, conv_kernel

    out = []
    for n, h, w, cin, cout, same, relu, dtype in (
            (4, 290, 500, 128, 128, False, False, torch.float32),
            (4, 290, 500, 128, 128, False, False, torch.bfloat16),
            (2, 64, 96, 128, 256, True, True, torch.float32),
            (2, 64, 96, 128, 256, True, True, torch.bfloat16)):
        x = torch.randn(n, h, w, cin, generator=g).to("cuda", dtype)
        wt = (torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        pad = 1 if same else 0
        fn = conv_kernel.conv3x3 if same else conv_kernel.conv3x3_valid
        entry = _conv_in.conv_route(dtype, 3, 3, 1, pad, cin, cout)
        before = conv_kernel.KERNEL.routes.get(entry, 0)
        got = fn(x, wt, b, relu)
        want = conv_kernel.conv3x3_plain(x, wt, b, relu, pad)
        torch.cuda.synchronize()
        if conv_kernel.KERNEL.routes.get(entry, 0) != before + 1:
            raise AssertionError(f"K4 {dtype}: the launch did not take {entry}")
        y, yp = got.float(), want.float()
        rel = ((y - yp).norm() / yp.norm()).item()
        err = (y - yp).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        ms = _time_ms(torch, lambda: fn(x, wt, b, relu))
        dev_ms = _profile_ms(torch, lambda: fn(x, wt, b, relu), SYMBOLS[entry])
        plain_ms = _time_ms(torch, lambda: conv_kernel.conv3x3_plain(x, wt, b, relu, pad))
        xc, wc, bc = x.permute(0, 3, 1, 2), wt.to(dtype), b.to(dtype)
        lib_ms = _time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, 1, pad))
        esz = x.element_size()
        nbytes = (x.numel() + y.numel() + wt.numel()) * esz + b.numel() * 4
        flops = 2 * y.shape[0] * y.shape[1] * y.shape[2] * cout * cin * 9
        b_ms, b_by = bound(nbytes, flops, _dname(torch, dtype))
        log(f"K4 block conv ({n},{h},{w},{cin})->{cout} {'SAME' if same else 'VALID'} "
            f"relu={relu} {dtype} via {entry}: rel_l2 {rel:.3g} max_abs {err:.3g} "
            f"(tol {tol:g}) kernel {ms:.4f} ms (device {dev_ms:.4f} ms, profiler) plain "
            f"{plain_ms:.4f} ms conv2d {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / 1e9:.1f} GFLOP)")
        if not rel <= tol:
            raise AssertionError(f"K4 ({n},{h},{w},{cin})->{cout} {dtype}: rel {rel}")
        out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms, entry=entry))
    return out


def _footprint(m, box, f):
    """Pixels of the source box that a border map's taps touch inside an
    f x f image."""
    import numpy as np

    y0, y1, x0, x1 = box
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    sub = m[y0:y1, x0:x1].astype(np.float64)
    ok = np.all(np.abs(sub) < 9999.0 / 2, axis=-1)
    sy, sx = np.floor((yy + sub[..., 1])[ok]), np.floor((xx + sub[..., 0])[ok])
    rows = min(sy.max() + 2, f) - max(sy.min(), 0)
    cols = min(sx.max() + 2, f) - max(sx.min(), 0)
    return int(rows * cols)


def _strip_grid(torch, m, box, f):
    """grid_sample's grid over a border map's box in an f x f image: the
    normalized absolute source coordinates, far outside for unmapped
    pixels."""
    import numpy as np

    y0, y1, x0, x1 = box
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    sub = m[y0:y1, x0:x1].astype(np.float64)
    ok = np.all(np.abs(sub) < 9999.0 / 2, axis=-1)
    gx = np.where(ok, (xx + sub[..., 0]) * 2 / (f - 1) - 1, -10.0)
    gy = np.where(ok, (yy + sub[..., 1]) * 2 / (f - 1) - 1, -10.0)
    return torch.from_numpy(np.stack([gx, gy], -1)[None].astype(np.float32)).cuda()


def _grid_sample_warp(torch, m, box, f):
    """The exact warp of a border map by grid_sample over its box (bilinear,
    zero padding, align_corners), the rest of the (f, f, 3) frame zero."""
    y0, y1, x0, x1 = box
    grid = _strip_grid(torch, m, box, f)

    def warp(img):
        out = torch.zeros((f, f, img.shape[-1]), device="cuda")
        out[y0:y1, x0:x1] = torch.nn.functional.grid_sample(
            img.float().permute(2, 0, 1)[None], grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)[0].permute(1, 2, 0)
        return out
    return warp


def check_strip_sum(torch, g):
    """K5's summing entry at 922-px faces (overlap 128), float32 and
    bfloat16 faces: the cross-face blend of all six faces in one launch
    (the VR path's per-frame shape) and the border prior of position 4,
    against their plain composition (max-abs 1e-5). Beside the kernel: the
    composition the VR driver ran before the summing entry (24 or 4
    single-map K5 launches, rotated copies, torch adds and divides), and
    the same composition over grid_sample warps (the library yardstick),
    each on CUDA events and as device time (every kernel of a call)."""
    from fast_artistic_videos_tpu_torch.ops import strip_warp_kernel as swk
    from fast_artistic_videos_tpu_torch.video import driver_vr

    f = VR_FACE
    opt = driver_vr.VROptions(overlap_pixel_w=VR_OVERLAP, overlap_pixel_h=VR_OVERLAP)
    geo = driver_vr._Geometry(f, f, opt, torch.device("cuda"))
    sums = geo.borders
    if not isinstance(sums, swk.StripSet):
        raise AssertionError("K5 sum: a 922-px border map has no strip warp")
    maps = (geo.map_left, geo.map_right, geo.map_top, geo.map_bottom)
    before = swk.BorderSums(*sums.warps)        # one single-map launch per term
    library = swk.BorderSums(*(_grid_sample_warp(torch, m, wp.box, f)
                               for m, wp in zip(maps, sums.warps)))
    footprint = [_footprint(m, wp.box, f) for m, wp in zip(maps, sums.warps)]
    tables = sum(sum(t.numel() * 4 for t in wp.tables(torch.device("cuda")))
                 for wp in sums.warps)
    gm, div = geo.grad_all, geo.mask_all_div
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        faces = [torch.rand((f, f, 3), generator=g).to("cuda", dtype) for _ in range(6)]
        esz = faces[0].element_size()
        for case in ("blend", 4):
            if case == "blend":
                def call(o, _fn="blend"):
                    return getattr(o, _fn)(faces, gm, div)
                terms = swk.BLEND_TERMS
                # every face read once (the taps lie in them), gm and div,
                # the tables, the six blended faces written once
                nbytes = 6 * f * f * 3 * (esz + 4) + 2 * f * f * 4 + tables
            else:
                def call(o, _fn="prior"):
                    return [getattr(o, _fn)(case, faces[:4], div)]
                terms = (swk.PRIOR_TERMS[case],)
                # the strips the taps touch, div, the tables, the prior
                nbytes = (sum(footprint[m] for m, _, _ in terms[0]) * 3 * esz
                          + f * f * 4 * (1 + 3) + tables)
            flops = sum(12 * 3 * (sums.warps[m].box[1] - sums.warps[m].box[0])
                        * (sums.warps[m].box[3] - sums.warps[m].box[2])
                        for t in terms for m, _, _ in t) + len(terms) * f * f * 3 * 4
            got = call(sums)
            want = call(sums, "blend_plain" if case == "blend" else "prior_plain")
            lib_out = call(library)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            lib_err = max((a - b).abs().max().item() for a, b in zip(lib_out, want))
            ms = _time_ms(torch, lambda: call(sums))
            dev_ms = _profile_ms(torch, lambda: call(sums), SYMBOLS["fav_strip_warp_sum"])
            plain_ms = _time_ms(torch, lambda: call(
                sums, "blend_plain" if case == "blend" else "prior_plain"))
            before_ms = _time_ms(torch, lambda: call(before))
            before_dev = _profile_total_ms(torch, lambda: call(before))
            lib_ms = _time_ms(torch, lambda: call(library))
            lib_dev = _profile_total_ms(torch, lambda: call(library))
            b_ms, b_by = bound(nbytes, flops, "float32")
            name = "blend (6 faces)" if case == "blend" else f"prior position {case}"
            log(f"K5 strip warp sum, {name}, {f}x{f}x3 {dtype} faces: max_abs_err {err:.3g} "
                f"(tol 1e-5) kernel {ms:.4f} ms (device {dev_ms:.4f} ms, profiler) plain "
                f"{plain_ms:.4f} ms; before the summing entry {before_ms:.4f} ms (device "
                f"{before_dev:.4f} ms, {sum(len(t) for t in terms)} single-map launches + "
                f"torch ops); over grid_sample {lib_ms:.4f} ms (device {lib_dev:.4f} ms; vs "
                f"plain {lib_err:.3g}) bound {b_ms:.4f} ms ({b_by})")
            if not err <= 1e-5:
                raise AssertionError(f"K5 sum {name} {dtype}: err {err}")
            out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                            entry="fav_strip_warp_sum", case=name, before_ms=before_ms,
                            before_device_ms=before_dev, library_device_ms=lib_dev))
    return out


def check_strip_warp(torch, g):
    """K5 on the four 922-px border maps (overlap 128), C = 3, float32 and
    bfloat16 input, against its plain version; the library yardstick is
    grid_sample over the strip (bilinear, zero padding, align_corners)."""
    from fast_artistic_videos_tpu_torch.ops import strip_warp_kernel
    from fast_artistic_videos_tpu_torch.video import vr_geometry as vr

    f = VR_FACE
    maps = {"left": vr.perspective_warp_map_left(f, VR_OVERLAP, f),
            "right": vr.perspective_warp_map_right(f, VR_OVERLAP, f),
            "top": vr.perspective_warp_map_top(f, VR_OVERLAP, f),
            "bottom": vr.perspective_warp_map_bottom(f, VR_OVERLAP, f)}
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        img = torch.rand((f, f, 3), generator=g).to("cuda", dtype)
        for name, m in maps.items():
            fn = strip_warp_kernel.make_static_strip_warp(m)
            got = fn(img)
            want = fn.plain(img)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ms = _time_ms(torch, lambda: fn(img))
            plain_ms = _time_ms(torch, lambda: fn.plain(img))
            # grid_sample over the strip: normalized absolute source coords
            y0, y1, x0, x1 = fn.box
            grid = _strip_grid(torch, m, fn.box, f)
            src = img.float().permute(2, 0, 1)[None]

            def lib():
                return torch.nn.functional.grid_sample(
                    src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
            lib_err = (lib()[0].permute(1, 2, 0) - want[y0:y1, x0:x1]).abs().max().item()
            lib_ms = _time_ms(torch, lib)
            # the kernel's own device time (the event time above includes
            # the host's launch path)
            dev_ms = _profile_ms(torch, lambda: fn(img), "strip_warp_kernel")
            # the least bytes: the source box the taps touch (inside the
            # image), read once, and the output frame written once; 6
            # multiply-adds per element
            b_ms, b_by = bound(_footprint(m, fn.box, f) * 3 * img.element_size()
                               + got.numel() * 4,
                               12 * (y1 - y0) * (x1 - x0) * 3, _dname(torch, dtype))
            log(f"K5 strip warp {name} {f}x{f}x3 {dtype}: max_abs_err {err:.3g} (tol 1e-5) "
                f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, profiler) plain "
                f"{plain_ms:.4f} ms grid_sample {lib_ms:.4f} ms "
                f"(vs plain {lib_err:.3g}) bound {b_ms:.4f} ms ({b_by})")
            if not err <= 1e-5:
                raise AssertionError(f"K5 {name} {dtype}: err {err}")
            out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                            entry="fav_strip_warp"))
    return out


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
    (results, seconds on CUDA events). record collects every stylized frame
    the engine returns. write=False skips the PNG encoding (the writer
    thread still downloads every uint8 frame)."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver

    device = cli.resolve_device("cuda")
    engine = cli.build_engine(opt, device)
    provider = cli.build_flow_provider(opt, device) if opt.flow_model else None
    if record is not None:
        for name in ("stylize_first", "stylize_next", "stylize_next_full",
                     "stylize_next_reuse", "stylize_batch"):
            fn = getattr(engine, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                if _name == "stylize_batch":
                    record.extend(out)
                else:
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


def run_main_path(torch, workdir, k1):
    import numpy as np
    from fast_artistic_videos_tpu_torch.core import io

    kernels = _kernels()
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
    expect = {"front_conv": 3 * n, "res_chain_conv": 10 * n, "warp_banded": pairs * (1 + 6 + 1),
              "conv3x3": 0, "strip_warp": 0}
    counted, routes, k1_routes = {}, {}, {}
    fps = {}
    for dtype in ("float32", "bfloat16"):
        prefix = os.path.join(workdir, dtype, "o")
        _drive(torch, _options(pattern, prefix, dtype, 3))     # warm-up, not counted
        _reset(kernels)
        outs = []
        with k1.recording():
            results, secs = _drive(torch, _options(pattern, prefix, dtype, n), record=outs)
        launches = {name: k.launches for name, k in kernels.items()}
        k1.check(kernels["warp_banded"], f"main path {dtype}")
        k1_routes[dtype] = dict(kernels["warp_banded"].routes)
        log(f"main path {dtype}: {len(results)} frames {SIZE_1080} in {secs:.3f} s "
            f"({len(results) / secs:.3f} fps, CUDA events over the whole run), "
            f"launches {launches}, expected {expect}")
        if len(results) != n or launches != expect:
            raise AssertionError(f"main path {dtype}: {len(results)} frames, "
                                 f"launches {launches} != {expect}")
        routes[dtype] = _check_routes(kernels, launches, dtype, "main path")
        for o in outs:
            if tuple(o.shape) != SIZE_1080 + (3,) or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"main path {dtype}: bad output {tuple(o.shape)}")
        last = io.load_image_u8(f"{prefix}-{n:05d}.png")
        if last.shape != SIZE_1080 + (3,) or last.std() < 1.0:
            raise AssertionError("main path: the written frame is degenerate")
        counted[dtype] = launches
        fps[dtype] = len(results) / secs
        results, secs = _drive(torch, _options(pattern, prefix, dtype, n), write=False)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _drive(torch, _options(pattern, prefix, dtype, n), write=False)
        busy = _device_events(prof)[0] / 1000.0 / secs
        log(f"main path {dtype} without PNG encoding: {len(results) / secs:.3f} fps; device "
            f"kernel time / wall time {busy:.3f} (torch.profiler kernel time over the wall "
            f"time of the unprofiled run)")
    return counted, routes, fps, k1_routes


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


# ---------------------------------------------------------------------------
# phases 6 and 7: the VR main path
# ---------------------------------------------------------------------------

def _vr_options(pattern, prefix, dtype, frames):
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as vcli

    opt, _ = vcli.parse_options([
        "--input_pattern", pattern, "--output_prefix", prefix, "--model_vid", "demo",
        "--flow_model", "bundled", "--flow_scale", "0.5", "--dtype", dtype,
        "--num_frames", str(frames), "--overlap_pixel_w", str(VR_OVERLAP),
        "--overlap_pixel_h", str(VR_OVERLAP)])
    return opt


def _vr_build(torch, opt):
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as vcli
    from fast_artistic_videos_tpu_torch.video.driver_vr import VRDriver

    device = vcli.resolve_device("cuda")
    engine = vcli.build_engine(opt, device)
    return VRDriver(engine, opt, batched_flow_provider=vcli.build_flow_provider(opt, device))


def _vr_drive(torch, opt, record=None, write=True):
    """One VR CLI run through the CLI's build functions; returns (faces,
    seconds on CUDA events). write=False skips the PNG encoding (the writer
    thread still downloads every uint8 face)."""
    driver = _vr_build(torch, opt)
    if record is not None:
        for name in ("stylize_first", "stylize_with_prior"):
            fn = getattr(driver.engine, name)

            def wrapped(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                record.append(out)
                return out
            setattr(driver.engine, name, wrapped)
    if not write:
        driver.save = lambda path, u8: None
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    n = driver.run(progress=False)
    e.record()
    torch.cuda.synchronize()
    return n, s.elapsed_time(e) / 1000.0


def _device_events(prof, name=""):
    """(summed device time in ms, number of launches) of the kernels a
    torch.profiler run recorded whose name contains `name`."""
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name not in ev.key:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        total += t
        count += ev.count
    return total / 1000.0, count


def run_vr_path(torch, workdir, k1):
    """Phase 6. Returns ({dtype: launches}, {dtype: tensor-core launches},
    {dtype: fps})."""
    from fast_artistic_videos_tpu_torch.core import io

    kernels = _kernels()
    faces = vr_faces(11, VR_FRAMES, VR_FACE, VR_PAN)
    d = os.path.join(workdir, "vr")
    os.makedirs(d, exist_ok=True)
    for t, frame in enumerate(faces, 1):
        for k, img in enumerate(frame, 1):
            io.write_ppm(os.path.join(d, f"f{t:04d}_{k}.ppm"), img)
    pattern = os.path.join(d, "f%04d_%d.ppm")
    n = VR_FRAMES
    # per frame: K5 5 border priors + 1 cross-face blend, each one launch of
    # the summing entry (+ 4 single-map mask warps when the geometry is
    # built); per face: K3 3 and K2 10 launches; per frame after the first:
    # K1 6 temporal warps, 6 feature warps (3 pyramid levels x 2
    # directions, the 6 faces batched) and 6 consistency samples
    expect = {"strip_warp": 6 * n + 4, "front_conv": 18 * n, "res_chain_conv": 60 * n,
              "warp_banded": 18 * (n - 1), "conv3x3": 0}
    expect_k5 = {"fav_strip_warp": 4, "fav_strip_warp_sum": 6 * n}
    counted, routes, fps = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        prefix = os.path.join(d, dtype, "o")
        _vr_drive(torch, _vr_options(pattern, prefix, dtype, 2))       # warm-up
        _reset(kernels)
        outs = []
        with k1.recording():
            faces_done, secs = _vr_drive(torch, _vr_options(pattern, prefix, dtype, n),
                                         record=outs)
        launches = {name: k.launches for name, k in kernels.items()}
        k1.check(kernels["warp_banded"], f"VR path {dtype}")
        log(f"VR path {dtype}: {faces_done} faces ({n} frames of 6 x {VR_FACE}^2, overlap "
            f"{VR_OVERLAP}) in {secs:.3f} s ({n / secs:.3f} fps, CUDA events over the whole "
            f"run, PNG output), launches {launches}, expected {expect}")
        if faces_done != 6 * n or launches != expect:
            raise AssertionError(f"VR path {dtype}: {faces_done} faces, "
                                 f"launches {launches} != {expect}")
        routes[dtype] = _check_routes(kernels, launches, dtype, "VR path")
        k5 = dict(kernels["strip_warp"].routes)
        log(f"VR path {dtype}: K5 launches by C entry {k5}, expected {expect_k5}")
        if k5 != expect_k5:
            raise AssertionError(f"VR path {dtype}: K5 launches by C entry {k5} != {expect_k5}")
        launches["strip_warp"], launches["strip_warp_sum"] = (k5["fav_strip_warp"],
                                                              k5["fav_strip_warp_sum"])
        if len(outs) != 6 * n:
            raise AssertionError(f"VR path {dtype}: {len(outs)} stylized faces")
        for o in outs:
            if tuple(o.shape) != (VR_FACE, VR_FACE, 3) or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"VR path {dtype}: bad face {tuple(o.shape)}")
        last = io.load_image_u8(f"{prefix}{n}_5.png")
        if last.shape != (VR_FACE, VR_FACE, 3) or last.std() < 1.0:
            raise AssertionError("VR path: the written face is degenerate")
        counted[dtype] = launches
        fps[dtype] = n / secs
        _, secs = _vr_drive(torch, _vr_options(pattern, prefix, dtype, n), write=False)
        fps[dtype + "_no_png"] = n / secs
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _vr_drive(torch, _vr_options(pattern, prefix, dtype, n), write=False)
        busy = _device_events(prof)[0] / 1000.0 / secs
        log(f"VR path {dtype} without PNG encoding: {n / secs:.3f} fps; device kernel "
            f"time / wall time {busy:.3f} (torch.profiler kernel time over the wall time "
            f"of the unprofiled run)")
    vr_stage_times(torch, faces)
    return counted, routes, fps


def vr_stage_times(torch, faces):
    """Per-frame device time of the VR stages (CUDA events, median of 8): the
    batched flow step, one face step (position 4: its border prior, the
    temporal warp, the stylizer), and the blend plus the outputs. Then that
    face step through the kernels against the plain versions (K5's plain
    composition, K1 and the cuDNN stylizer) on the same input: float32
    max-abs <= 1e-3, bfloat16 mean-abs <= 1e-2, on the [0, 1] output."""
    from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer
    from fast_artistic_videos_tpu_torch.ops import strip_warp_kernel, warp_kernel

    dev = torch.device("cuda")
    spec = checkpoint.load_model("demo")[0]
    frames = [torch.from_numpy(f).to(dev).float() / 255.0 for f in faces[:2]]
    for dtype in ("float32", "bfloat16"):
        driver = _vr_build(torch, _vr_options("unused_%d_%d.ppm", "unused", dtype, 2))
        driver._geometry(frames[0][0])
        provider = driver.batched_flow
        provider(frames[0])
        driver._streamed = provider(frames[1])
        driver.segments = [frames[1][p] for p in range(6)]
        driver.prev_segments = [frames[0][p] for p in range(6)]
        step = [0]

        def flow_step():
            step[0] += 1
            return provider(frames[step[0] % 2])
        t_flow = _time_ms(torch, flow_step, n=8)
        i, img = 7 + 4, frames[1][4]
        t_face = _time_ms(torch, lambda: driver._face_step(i, img), n=8)
        t_out = _time_ms(torch, lambda: driver._outputs(driver.blend_other_sides()), n=8)
        got = driver._face_step(i, img)
        # the same step through the plain versions on the card
        g = driver.geo
        kernel_borders = g.borders
        apply_vid = driver.engine.apply_vid
        banded = warp_kernel.warp_banded
        g.borders = strip_warp_kernel.BorderSums(*kernel_borders.plain_warps)
        driver.engine.apply_vid = lambda p, x: stylizer.apply(p, spec, x, fused=False)
        warp_kernel.warp_banded = warp_kernel.warp_banded_plain
        try:
            want = driver._face_step(i, img)
        finally:
            g.borders = kernel_borders
            driver.engine.apply_vid = apply_vid
            warp_kernel.warp_banded = banded
        diff = (got - want).abs()
        err, tol = ((diff.max().item(), 1e-3) if dtype == "float32"
                    else (diff.mean().item(), 1e-2))
        log(f"VR stages {dtype} ({VR_FACE}^2 faces): batched flow step {t_flow:.3f} ms/frame "
            f"(band {provider.last_band}), one face step {t_face:.3f} ms, blend + outputs "
            f"{t_out:.3f} ms; face step kernels vs plain versions "
            f"{'max' if dtype == 'float32' else 'mean'}-abs {err:.3g} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"VR face step {dtype}: kernel path vs plain {err} > {tol}")


def check_vr_fixture(torch, workdir):
    """Phase 7."""
    import numpy as np
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as vcli
    from fast_artistic_videos_tpu_torch.core import io

    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_vr.npz")) as z:
        faces, want, overlap = z["faces"], z["outputs"], int(z["overlap"])
    d = os.path.join(workdir, "vr_fixture")
    os.makedirs(d, exist_ok=True)
    for t, frame in enumerate(faces, 1):
        for k, img in enumerate(frame, 1):
            io.write_ppm(os.path.join(d, f"f{t:04d}_{k}.ppm"), img)
    prefix = os.path.join(d, "out", "o")
    vcli.main(["--input_pattern", os.path.join(d, "f%04d_%d.ppm"), "--output_prefix", prefix,
               "--model_vid", "demo", "--flow_model", "bundled", "--flow_scale", "0.5",
               "--overlap_pixel_w", str(overlap), "--overlap_pixel_h", str(overlap),
               "--device", "cuda"])
    got = np.stack([np.stack([io.load_image_u8(f"{prefix}{t}_{p}.png") for p in range(6)])
                    for t in range(1, len(faces) + 1)])
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean(axis=(2, 3, 4)) / 255
    log(f"VR fixture parity (port VR CLI on the card vs JAX VR CLI on CPU), mean-abs per "
        f"face: max {float(err.max()):.3g} (tol 1e-2)")
    if got.shape != want.shape or not (err <= 1e-2).all():
        raise AssertionError(f"VR fixture parity failed: {err}")


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


# ---------------------------------------------------------------------------
# phases 8-10: the batched path, feature reuse and scale, their fixture
# ---------------------------------------------------------------------------

BATCH_FRAMES, BATCH_N = 8, 4


def run_batched_path(torch, workdir):
    """Phase 8 on the phase-4 frames. Returns ({dtype: launches}, {dtype:
    tensor-core launches}, {dtype: fps}, {dtype: fps without PNG})."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.core import config, io

    kernels = _kernels()
    pattern = os.path.join(workdir, "frame_%05d.ppm")
    n = BATCH_FRAMES
    # one K4 launch per block conv (5 blocks x 2) per batch step
    expect = {name: 0 for name in kernels}
    expect["conv3x3"] = 10 * (n // BATCH_N)
    counted, routes, fps, fps_no_png = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        def opts(frames):
            return config.StylizeOptions(
                input_pattern=pattern, output_prefix=os.path.join(workdir, "b" + dtype, "o"),
                model_vid="demo", create_inconsistent=True, inconsistent_batch=BATCH_N,
                dtype=dtype, num_frames=frames)
        _drive(torch, opts(BATCH_N))                           # warm-up
        _reset(kernels)
        outs = []
        results, secs = _drive(torch, opts(n), record=outs)
        launches = {name: k.launches for name, k in kernels.items()}
        log(f"batched path {dtype}: {len(results)} frames {SIZE_1080} in batches of {BATCH_N} "
            f"in {secs:.3f} s ({n / secs:.3f} fps, CUDA events over the whole run, PNG "
            f"output), launches {launches}, expected {expect}")
        if len(results) != n or len(outs) != n or launches != expect:
            raise AssertionError(f"batched path {dtype}: {len(results)} frames, "
                                 f"launches {launches} != {expect}")
        routes[dtype] = _check_routes(kernels, launches, dtype, "batched path")
        for o in outs:
            if tuple(o.shape) != SIZE_1080 + (3,) or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"batched path {dtype}: bad output {tuple(o.shape)}")
        counted[dtype], fps[dtype] = launches, n / secs
        _, secs = _drive(torch, opts(n), write=False)
        fps_no_png[dtype] = n / secs
        # the same frames one at a time (batch 1: K3 + K2): instance-norm
        # statistics are per image, so batching changes nothing
        engine = cli.build_engine(opts(n), cli.resolve_device("cuda"))
        err = 0.0
        for t, o in enumerate(outs, 1):
            frame = torch.from_numpy(io.load_image_u8(pattern % t)).cuda()
            err = max(err, (engine.stylize_first(frame) - o).abs().mean().item())
        log(f"batched path {dtype} without PNG encoding: {fps_no_png[dtype]:.3f} fps; batched "
            f"vs one at a time (K3 + K2) mean-abs per frame max {err:.3g} (tol 1e-2)")
        if not err <= 1e-2:
            raise AssertionError(f"batched path {dtype}: batched vs unbatched {err}")
    return counted, routes, fps, fps_no_png


def _reuse_schedule(n, k):
    """(keyframes, reuse frames) of an n-frame --feature_reuse k run (frame
    1 is stylized independently): the driver's key_age rule."""
    keys = reuse = 0
    age = None
    for _ in range(2, n + 1):
        if age is None or age >= k - 1:
            keys, age = keys + 1, 0
        else:
            reuse, age = reuse + 1, age + 1
    return keys, reuse


def run_reuse_and_scale(torch, workdir, k1):
    """Phase 9, float32, on the phase-4 frames; phase 4's float32 PNGs are
    the exact run. Returns {"reuse": fps, "reuse_no_png": fps, "scale": fps}."""
    import dataclasses

    import numpy as np
    from fast_artistic_videos_tpu_torch.core import io

    kernels = _kernels()
    pattern = os.path.join(workdir, "frame_%05d.ppm")
    n, k = FRAMES_1080, 3
    keys, reuse = _reuse_schedule(n, k)
    pairs = n - 1
    # K2: frame 1 and every keyframe's middle segment; K3: frame 1 only (the
    # split's front stops at the reuse tap, before the fused front applies);
    # K1: the provider's 7 per pair, the prior warp per step, the delta warp
    # per reuse frame
    expect = {"front_conv": 3, "res_chain_conv": 10 * (1 + keys),
              "warp_banded": 7 * pairs + pairs + reuse, "conv3x3": 0, "strip_warp": 0}
    prefix = os.path.join(workdir, "reuse", "o")
    opt = dataclasses.replace(_options(pattern, prefix, "float32", n), feature_reuse=k)
    _drive(torch, dataclasses.replace(opt, num_frames=4))        # warm-up
    _reset(kernels)
    outs = []
    with k1.recording():
        results, secs = _drive(torch, opt, record=outs)
    launches = {name: kk.launches for name, kk in kernels.items()}
    k1.check(kernels["warp_banded"], "feature reuse")
    fps = {"reuse": n / secs}
    log(f"feature reuse 3, float32: {n} frames {SIZE_1080} ({keys} keyframes, {reuse} reuse "
        f"frames) in {secs:.3f} s ({n / secs:.3f} fps, CUDA events, PNG output), launches "
        f"{launches}, expected {expect}")
    if len(results) != n or launches != expect:
        raise AssertionError(f"feature reuse: launches {launches} != {expect}")
    _check_routes(kernels, launches, "float32", "feature reuse")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("feature reuse: non-finite output")
    exact = [io.load_image_u8(os.path.join(workdir, "float32", f"o-{t:05d}.png"))
             for t in range(1, n + 1)]
    got = [io.load_image_u8(f"{prefix}-{t:05d}.png") for t in range(1, n + 1)]
    d12 = max(int(np.abs(g.astype(int) - e.astype(int)).max()) for g, e in zip(got[:2], exact[:2]))
    mae = [float(np.abs(g.astype(np.float32) - e.astype(np.float32)).mean() / 255)
           for g, e in zip(got[2:], exact[2:])]
    log(f"feature reuse vs the exact run (phase 4, float32): frames 1-2 max uint8 diff {d12} "
        f"(tol 1), frames 3-{n} mean-abs {[round(m, 5) for m in mae]} (tol 0.05)")
    if d12 > 1 or not max(mae) < 0.05:
        raise AssertionError(f"feature reuse: frames 1-2 diff {d12}, reuse mae {mae}")
    _, secs = _drive(torch, opt, write=False)
    fps["reuse_no_png"] = n / secs
    log(f"feature reuse 3 float32 without PNG encoding: {fps['reuse_no_png']:.3f} fps")
    # --scale_factor 0.5: stylized at 540x960, written at 1080x1920
    ns = 6
    sprefix = os.path.join(workdir, "scale", "o")
    sopt = dataclasses.replace(_options(pattern, sprefix, "float32", ns), scale_factor=0.5)
    outs = []
    results, secs = _drive(torch, sopt, record=outs)
    fps["scale"] = ns / secs
    written = [io.load_image_u8(f"{sprefix}-{t:05d}.png") for t in range(1, ns + 1)]
    log(f"scale 0.5 float32: {ns} frames in {secs:.3f} s ({fps['scale']:.3f} fps, PNG output); "
        f"stylized {tuple(outs[0].shape)}, written {written[0].shape}")
    if (len(results) != ns or any(w.shape != SIZE_1080 + (3,) for w in written)
            or any(tuple(o.shape) != (540, 960, 3) or not bool(torch.isfinite(o).all())
                   for o in outs)):
        raise AssertionError("scale 0.5: bad output")
    return fps


def check_batch_fixture(torch, workdir):
    """Phase 10."""
    import numpy as np
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.core import io

    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_batch.npz")) as z:
        fx = {k: z[k] for k in z.files}
    for name in ("batch", "reuse", "scale", "phase"):
        want = fx[f"outputs_{name}"]
        n = len(want)
        d = os.path.join(workdir, "fixture_" + name)
        os.makedirs(d, exist_ok=True)
        for t, f in enumerate(fx["frames"][:n], 1):
            io.write_ppm(os.path.join(d, f"frame_{t:05d}.ppm"), f)
        prefix = os.path.join(d, "out", "o")
        args = [str(a) for a in fx[f"args_{name}"]]
        cli.main(["--input_pattern", os.path.join(d, "frame_%05d.ppm"), "--model_vid", "demo",
                  "--flow_model", "bundled", "--flow_scale", "0.5", "--output_prefix", prefix,
                  "--num_frames", str(n), "--device", "cuda", *args])
        got = np.stack([io.load_image_u8(f"{prefix}-{t:05d}.png") for t in range(1, n + 1)])
        err = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean(axis=(1, 2, 3)) / 255
        log(f"batch fixture parity {' '.join(args)} (port CLI on the card vs JAX CLI on CPU): "
            f"mean-abs per frame {[float(e) for e in err]}, max uint8 diff "
            f"{int(np.abs(got.astype(int) - want.astype(int)).max())} (tol mean-abs 1e-2)")
        if got.shape != want.shape or not (err <= 1e-2).all():
            raise AssertionError(f"batch fixture parity {name} failed: {err}")


# ---------------------------------------------------------------------------
# phases 11-13: evaluation, the flow-file and VR-file paths
# ---------------------------------------------------------------------------

EVAL_VGG_SEED = 20261019     # tools/make_torch_parity_fixture.py's EVAL_VGG_SEED
EQUI_SIZE, EQUI_FACE, EQUI_FRAMES = (1536, 3072), 768, 3


def vgg_npz(seed, path):
    """A full-width VGG-16 .npz (HWIO) from a numpy seed, by
    tools/make_torch_parity_fixture.py's law: per conv in order, weights
    then bias uniform in (-s, s), s = 1/sqrt(9 Cin), float32."""
    import numpy as np
    from fast_artistic_videos_tpu_torch.models import vgg

    rng = np.random.default_rng(seed)
    flat = {}
    for idx, op, cin, cout in vgg.VGG16_LAYOUT:
        if op == "conv":
            s = 1.0 / np.sqrt(9 * cin)
            flat[f"conv{idx:02d}/w"] = rng.uniform(-s, s, (3, 3, cin, cout)).astype(np.float32)
            flat[f"conv{idx:02d}/b"] = rng.uniform(-s, s, cout).astype(np.float32)
    np.savez(path, **flat)
    return path


def write_pan_flow(workdir, n, h, w, step, faces=()):
    """Ground truth of a pan_frames pan (tools/make_torch_parity_fixture.py's
    write_pan_flow): backward flow exactly `step`, certainty 0 in the band
    the pan reveals. Returns the flow and certainty patterns."""
    import numpy as np
    from fast_artistic_videos_tpu_torch.core import io

    os.makedirs(workdir, exist_ok=True)
    sx, sy = step
    flow = np.empty((h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = sx, sy
    ys, xs = np.mgrid[0:h, 0:w]
    cert = (((xs + sx) <= w - 1) & ((ys + sy) <= h - 1)).astype(np.uint8) * 255
    suffixes = [f"_{k}" for k in faces] or [""]
    for t in range(2, n + 1):
        for sfx in suffixes:
            io.write_flo(os.path.join(workdir, f"backward_{t}_{t - 1}{sfx}.flo"), flow)
            io.write_pgm(os.path.join(workdir, f"reliable_{t}_{t - 1}{sfx}.pgm"), cert)
    tail = "_%d" if faces else ""
    return (os.path.join(workdir, "backward_[%d]_{%d}" + tail + ".flo"),
            os.path.join(workdir, "reliable_[%d]_{%d}" + tail + ".pgm"))


def _eval_file(path):
    lines = open(path).read().strip().split("\n")
    n = len(lines) // 2
    return ([[float(v) for v in line.split(";")] for line in lines[:n]],
            [float(v) for v in lines[n:]])


class _Timed:
    """Wraps a callable; the CUDA-event milliseconds of each call."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.ms, self.last = torch, fn, [], None

    def __call__(self, *a):
        s = self.torch.cuda.Event(enable_timing=True)
        e = self.torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.fn(*a)
        e.record()
        e.synchronize()
        self.ms.append(s.elapsed_time(e))
        self.last = a
        return out


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def run_eval_path(torch, workdir, k1, smi):
    """Phase 11: the 2D --evaluate path at 1080p, float32. Returns
    {"scorer_ms": .., "row_ms": ..}."""
    import dataclasses
    import math

    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.models import registry
    from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver

    kernels = _kernels()
    n = FRAMES_1080
    pattern = os.path.join(workdir, "frame_%05d.ppm")
    gt = write_pan_flow(os.path.join(workdir, "eval_gt"), n, *SIZE_1080, PAN_1080)
    zero = write_pan_flow(os.path.join(workdir, "eval_zero"), n, *SIZE_1080, (0, 0))
    evfile = os.path.join(workdir, "eval_2d.txt")
    opt = dataclasses.replace(
        _options(pattern, os.path.join(workdir, "eval", "o"), "float32", n),
        evaluate=True, evaluation_file=evfile,
        loss_network=vgg_npz(EVAL_VGG_SEED, os.path.join(workdir, "vgg16.npz")),
        style_image=registry.style_fixture("candy"),
        flow_pattern_eval=gt[0], occlusions_pattern_eval=gt[1])
    device = cli.resolve_device("cuda")
    engine = cli.build_engine(opt, device)
    provider = cli.build_flow_provider(opt, device)
    evaluator = cli.build_evaluator(opt, device)
    if not all(leaf.is_cuda for p in evaluator.scorer.vgg_params.values()
               for leaf in p.values()):
        raise AssertionError("eval path: the scorer's VGG weights are not on the card")
    scorer = evaluator.scorer = _Timed(torch, evaluator.scorer)
    row_fn = _Timed(torch, evaluator)
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.monotonic()
    with k1.recording():
        results = VideoDriver(engine, opt, eval_fn=row_fn, flow_provider=provider).run(
            progress=False)
    secs = time.monotonic() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    k1.check(kernels["warp_banded"], "eval path")
    expect = {"front_conv": 3 * n, "res_chain_conv": 10 * n, "warp_banded": (n - 1) * 8,
              "conv3x3": 0, "strip_warp": 0}
    log(f"eval path float32: {len(results)} frames {SIZE_1080} with --evaluate in "
        f"{secs:.3f} s (host clock), launches {launches}, expected {expect}")
    if len(results) != n or launches != expect:
        raise AssertionError(f"eval path: launches {launches} != {expect}")
    _check_routes(kernels, launches, "float32", "eval path")
    series, means = _eval_file(evfile)
    if (len(series) != 3 or any(len(s) != n for s in series) or len(means) != 3
            or not all(math.isfinite(v) for s in series + [means] for v in s)):
        raise AssertionError(f"eval path: bad evaluation file {series} {means}")
    # the temporal term measures what it should: the ground-truth flow
    # explains the last pair better than zero flow does
    i, content, stylized, prev = row_fn.last
    with_gt = series[2][-1]
    evaluator.opt = dataclasses.replace(opt, flow_pattern_eval=zero[0],
                                        occlusions_pattern_eval=zero[1])
    with_zero = evaluator(i, content, stylized, prev)[2]
    evaluator.opt = opt
    log(f"eval path: style {[round(v, 4) for v in series[0]]}, content "
        f"{[round(v, 4) for v in series[1]]}, temporal {[round(v, 6) for v in series[2]]}; "
        f"means {means}; frame {i} temporal error with the ground-truth flow {with_gt:.6g}, "
        f"with zero flow {with_zero:.6g}")
    if not (0 < with_gt < with_zero) or series[2][0] != 0.0:
        raise AssertionError(f"eval path: temporal error {with_gt} (ground truth) vs "
                             f"{with_zero} (zero flow)")
    out = {"scorer_ms": _median(scorer.ms[1:]), "row_ms": _median(row_fn.ms[1:])}
    log(f"eval path 1080p float32: scorer {out['scorer_ms']:.3f} ms/frame, whole row "
        f"(scorer + flow files + temporal) {out['row_ms']:.3f} ms/frame (CUDA events, "
        f"median of {n - 1}); {smi}")
    return out



def check_eval_fixture(torch, workdir):
    """Phase 12: the port's evaluators on the card against the JAX
    evaluators' rows (tests/fixtures/torch_parity_eval.npz) on the content
    frames and stylized outputs of the 2D and VR fixtures, rtol 1e-4 (atol
    1e-7 for the zeros)."""
    import types

    import numpy as np
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.core import config
    from fast_artistic_videos_tpu_torch.models import registry
    from fast_artistic_videos_tpu_torch.video import driver_vr, evaluation

    def load(name):
        with np.load(os.path.join(ROOT, "tests", "fixtures", name)) as z:
            return {k: z[k] for k in z.files}
    fx, demo, vr_fx = (load(f"torch_parity_{k}.npz") for k in ("eval", "demo", "vr"))
    dev = cli.resolve_device("cuda")
    d = os.path.join(workdir, "eval_fixture")
    vgg = vgg_npz(int(fx["vgg_seed"]), os.path.join(workdir, "eval_fixture_vgg16.npz"))
    style = registry.style_fixture("candy")

    def options(cls, pats, **kw):
        return cls(evaluate=True, loss_network=vgg, style_image=style,
                   style_image_size=int(fx["style_image_size"]), flow_pattern_eval=pats[0],
                   occlusions_pattern_eval=pats[1], **kw)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.float32) / 255.0).to(dev)
    n, h, w = demo["frames"].shape[:3]
    pats = write_pan_flow(d, n, h, w, tuple(int(v) for v in demo["step"]))
    ev = evaluation.VideoEvaluator(options(config.StylizeOptions, pats), dev)
    rows_2d = [ev(i, t(demo["frames"][i - 1]), t(demo["outputs"][i - 1]),
                  t(demo["outputs"][i - 2]) if i > 1 else None) for i in range(1, n + 1)]
    nv, _, face = vr_fx["faces"].shape[:3]
    overlap = int(vr_fx["overlap"])
    vpats = write_pan_flow(os.path.join(d, "vr"), nv, face, face,
                           tuple(int(v) for v in vr_fx["step"]), faces=range(1, 7))
    vopt = options(driver_vr.VROptions, vpats, overlap_pixel_w=overlap,
                   overlap_pixel_h=overlap)
    vev = evaluation.VREvaluator(vopt, dev)
    geo = driver_vr._Geometry(face, face, vopt, dev)
    rows_vr = []
    for f in range(nv):
        for pos in range(6):
            drv = types.SimpleNamespace(
                geo=geo, segments=[t(x) for x in vr_fx["outputs"][f]],
                prev_segments=[t(x) for x in vr_fx["outputs"][max(f - 1, 0)]],
                last_content=t(vr_fx["faces"][f][driver_vr.PROC_ORDER[pos] - 1]))
            rows_vr.append(vev(drv, f * 6 + pos + 1))
    worst = 0.0
    for got, want, name in ((rows_2d, fx["rows_2d"], "2D"), (rows_vr, fx["rows_vr"], "VR")):
        got = np.asarray(got)
        excess = np.abs(got - want) - (1e-4 * np.abs(want) + 1e-7)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-7)
        worst = max(worst, float(rel.max()))
        log(f"eval fixture parity {name} (port evaluator on the card vs JAX evaluator on "
            f"CPU): {got.shape[0]} rows of {got.shape[1]}, max relative error "
            f"{float(rel.max()):.3g} (tol rtol 1e-4, atol 1e-7)")
        if got.shape != want.shape or (excess > 0).any():
            raise AssertionError(f"eval fixture parity {name} failed: {got} vs {want}")
    return worst


def run_flow_file_paths(torch, workdir, k1, smi):
    """Phase 13: make_opt_flow on the card, then the stylize CLI on its
    files; stylize_vr_video_file --frames_dir on equirect frames; the VR
    --evaluate run. Returns {"scorer_face_ms": .., ...}."""
    import dataclasses
    import math

    import numpy as np
    from fast_artistic_videos_tpu_torch.cli import make_opt_flow, stylize_video as cli
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as vcli
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video_file
    from fast_artistic_videos_tpu_torch.core import io
    from fast_artistic_videos_tpu_torch.models import registry
    from fast_artistic_videos_tpu_torch.video.driver_vr import VRDriver

    kernels = _kernels()
    out = {}
    # (a) make_opt_flow --device cuda on 6 of the 1080p frames, then the
    # stylize CLI through --flow_pattern / --occlusions_pattern
    n = min(6, FRAMES_1080)
    d = os.path.join(workdir, "optflow")
    os.makedirs(d, exist_ok=True)
    for t in range(1, n + 1):
        os.symlink(os.path.join(workdir, f"frame_{t:05d}.ppm"),
                   os.path.join(d, f"frame_{t:05d}.ppm"))
    pattern = os.path.join(d, "frame_%05d.ppm")
    _reset(kernels)
    t0 = time.monotonic()
    with k1.recording():
        make_opt_flow.main(["--input_pattern", pattern, "--out_dir", os.path.join(d, "flow"),
                            "--flow_model", "bundled", "--device", "cuda"])
    out["make_opt_flow_s"], out["pairs"] = time.monotonic() - t0, n - 1
    launches = {name: k.launches for name, k in kernels.items()}
    k1.check(kernels["warp_banded"], "make_opt_flow")
    # 3 feature warps per direction per pair; the check samples exactly
    expect = {name: 0 for name in kernels}
    expect["warp_banded"] = 6 * (n - 1)
    log(f"make_opt_flow 1080p: {n - 1} pairs in {out['make_opt_flow_s']:.3f} s (host clock), "
        f"launches {launches}, expected {expect}")
    if launches != expect:
        raise AssertionError(f"make_opt_flow: launches {launches} != {expect}")
    for t in range(2, n + 1):
        for name in (f"backward_{t}_{t - 1}.flo", f"forward_{t - 1}_{t}.flo"):
            f = io.read_flo(os.path.join(d, "flow", name))
            if f.shape != SIZE_1080 + (2,) or not np.isfinite(f).all():
                raise AssertionError(f"make_opt_flow: bad {name}")
        bwd = io.read_flo(os.path.join(d, "flow", f"backward_{t}_{t - 1}.flo"))
        med = np.median(bwd[64:-64, 64:-64].reshape(-1, 2), axis=0)
        if np.abs(med - PAN_1080).max() > 0.5:
            raise AssertionError(f"make_opt_flow: pair {t}: median flow {med} != {PAN_1080}")
        for name in (f"reliable_{t}_{t - 1}.pgm", f"reliable_{t - 1}_{t}.pgm"):
            if io.read_pnm(os.path.join(d, "flow", name)).shape[:2] != SIZE_1080:
                raise AssertionError(f"make_opt_flow: bad {name}")
    opt = dataclasses.replace(
        _options(pattern, os.path.join(d, "out", "o"), "float32", n), flow_model="",
        flow_pattern=os.path.join(d, "flow", "backward_[%d]_{%d}.flo"),
        occlusions_pattern=os.path.join(d, "flow", "reliable_[%d]_{%d}.pgm"))
    _reset(kernels)
    outs = []
    with k1.recording():
        results, secs = _drive(torch, opt, record=outs)
    launches = {name: k.launches for name, k in kernels.items()}
    k1.check(kernels["warp_banded"], "file flow")
    expect = {"front_conv": 3 * n, "res_chain_conv": 10 * n, "warp_banded": n - 1,
              "conv3x3": 0, "strip_warp": 0}
    log(f"stylize CLI on make_opt_flow's files, float32: {len(results)} frames in {secs:.3f} s, "
        f"launches {launches}, expected {expect}")
    if (len(results) != n or launches != expect
            or not all(bool(torch.isfinite(o).all()) for o in outs)):
        raise AssertionError(f"file flow: launches {launches} != {expect} or bad output")
    _check_routes(kernels, launches, "float32", "file flow")
    # (b) stylize_vr_video_file --frames_dir on seeded equirect frames
    e = os.path.join(workdir, "equi")
    os.makedirs(e, exist_ok=True)
    for t, f in enumerate(pan_frames(13, EQUI_FRAMES, *EQUI_SIZE, (8, 0)), 1):
        io.write_ppm(os.path.join(e, f"equi_{t:05d}.ppm"), f)
    _reset(kernels)
    t0 = time.monotonic()
    with k1.recording():
        rc = stylize_vr_video_file.main([
            "--frames_dir", e, "--model_vid", "demo", "--flow_model", "bundled",
            "--flow_scale", "0.5", "--face_size", str(EQUI_FACE), "--no_encode",
            "--out_dir", os.path.join(workdir, "equi_out"), "--device", "cuda"])
    out["vr_file_s"] = time.monotonic() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    k1.check(kernels["warp_banded"], "VR file CLI")
    log(f"stylize_vr_video_file: {EQUI_FRAMES} equirect frames {EQUI_SIZE[1]}x{EQUI_SIZE[0]}, "
        f"faces {EQUI_FACE} + {EQUI_FACE // 6} overlap, bfloat16, in {out['vr_file_s']:.3f} s "
        f"(host clock, face split and PNG included), launches {launches}")
    if rc != 0 or not all(launches[k] > 0 for k in ("warp_banded", "res_chain_conv",
                                                     "front_conv", "strip_warp")):
        raise AssertionError(f"stylize_vr_video_file: rc {rc}, launches {launches}")
    for t in range(1, EQUI_FRAMES + 1):
        img = io.load_image_u8(os.path.join(workdir, "equi_out", f"out-{t:05d}_equi.png"))
        if img.shape != EQUI_SIZE + (3,) or img.std() < 1.0:
            raise AssertionError(f"stylize_vr_video_file: bad equirect frame {t}")
    # (c) the VR --evaluate run at phase 6's face size, 2 frames
    vd = os.path.join(workdir, "vr")
    nv = 2
    gt = write_pan_flow(os.path.join(workdir, "vr_gt"), nv, VR_FACE, VR_FACE, VR_PAN,
                        faces=range(1, 7))
    evfile = os.path.join(workdir, "eval_vr.txt")
    vopt = dataclasses.replace(
        _vr_options(os.path.join(vd, "f%04d_%d.ppm"), os.path.join(vd, "e", "o"), "float32",
                    nv),
        evaluate=True, evaluation_file=evfile,
        loss_network=os.path.join(workdir, "vgg16.npz"),      # phase 11's
        style_image=registry.style_fixture("candy"),
        flow_pattern_eval=gt[0], occlusions_pattern_eval=gt[1])
    device = cli.resolve_device("cuda")
    evaluator = vcli.build_evaluator(vopt, device)
    if not evaluator.scorer.vgg_params["conv01"]["w"].is_cuda:
        raise AssertionError("VR eval: the scorer's VGG weights are not on the card")
    scorer = evaluator.scorer = _Timed(torch, evaluator.scorer)
    driver = VRDriver(vcli.build_engine(vopt, device), vopt, eval_fn=evaluator,
                      batched_flow_provider=vcli.build_flow_provider(vopt, device))
    _reset(kernels)
    with k1.recording():
        faces_done = driver.run(progress=False)
    launches = {name: k.launches for name, k in kernels.items()}
    k1.check(kernels["warp_banded"], "VR --evaluate")
    expect = {"strip_warp": 6 * nv + 4, "front_conv": 18 * nv, "res_chain_conv": 60 * nv,
              "warp_banded": 18 * (nv - 1), "conv3x3": 0}
    series, means = _eval_file(evfile)
    log(f"VR --evaluate float32: {faces_done} faces, launches {launches}, expected {expect}; "
        f"series {[[round(v, 5) for v in s] for s in series]}, means {means}")
    if (faces_done != 6 * nv or launches != expect or len(series) != 7
            or any(len(s) != 6 * nv for s in series) or len(means) != 7
            or not all(math.isfinite(v) for s in series + [means] for v in s)
            or not all(v > 0 for v in series[6][6:])):
        raise AssertionError("VR --evaluate: bad run or evaluation file")
    out["scorer_face_ms"] = _median(scorer.ms[6:])
    log(f"VR --evaluate {VR_FACE}^2 faces: scorer {out['scorer_face_ms']:.3f} ms/face (CUDA "
        f"events, median of the second frame's 6); {smi}")
    return out


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
    from fast_artistic_videos_tpu_torch.ops import _build

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
    mma = sass_mma_counts(_build.LIBRARY.path())
    for name, (hgmma, hmma) in mma.items():
        log(f"SASS of {name}: {hgmma} HGMMA, {hmma} HMMA instructions (cuobjdump)")
    # conv_tc.cu's kernel and every instantiation of front_tc.cu's (wgmma)
    fronts = [name for name in mma if SYMBOLS["fav_front_tc"] in name]
    if (not fronts or len(fronts) == len(mma)
            or not all(hg + hm > 0 for hg, hm in mma.values())
            or not all(mma[name][0] > 0 for name in fronts)):
        raise AssertionError(f"a tensor-core kernel has no tensor-core instructions: {mma}")
    # 3. kernels
    res = check_kernels(torch)
    with tempfile.TemporaryDirectory() as work:
        # 4. 2D main path; 5. its fixture parity; 6. VR main path; 7. its
        # fixture parity
        k1 = WarpShapes()
        counted, routes, fps, k1_routes = run_main_path(torch, work, k1)
        stage_times(torch, work)
        check_fixture(torch, work)
        vr_counted, vr_routes, vr_fps = run_vr_path(torch, work, k1)
        check_vr_fixture(torch, work)
        # 8. batched path; 9. feature reuse and scale; 10. their fixture
        b_counted, b_routes, b_fps, b_fps_no_png = run_batched_path(torch, work)
        r_fps = run_reuse_and_scale(torch, work, k1)
        check_batch_fixture(torch, work)
        # 11. the 2D --evaluate path; 12. the evaluators against the JAX
        # evaluators' fixture; 13. make_opt_flow, the VR file CLI, VR --evaluate
        t_new = time.monotonic()
        ev_ms = run_eval_path(torch, work, k1, smi)
        eval_worst = check_eval_fixture(torch, work)
        ff = run_flow_file_paths(torch, work, k1, smi)
        t_new = time.monotonic() - t_new
    # 3, continued: K1 at every shape phases 4, 6, 9, 11 and 13 launched
    check_recorded_warps(torch, res, k1)
    torch.cuda.synchronize()

    rows = []
    # launches: K5 from the VR path's runs, K4 from the batched path's, the
    # others from the 2D path's; float32 at the top level, bfloat16 beside
    def figures(c):
        return {"ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}

    kernels = _kernels()
    # (row, kernel): K5's two C entries get a row each, launches by entry
    for name, kname, launches, tc in (("warp_banded", "warp_banded", counted, routes),
                                      ("res_chain_conv", "res_chain_conv", counted, routes),
                                      ("front_conv", "front_conv", counted, routes),
                                      ("conv3x3", "conv3x3", b_counted, b_routes),
                                      ("strip_warp", "strip_warp", vr_counted, vr_routes),
                                      ("strip_warp_sum", "strip_warp", vr_counted, vr_routes)):
        k = kernels[kname]
        cases = res[name]
        # the first case of each dtype is the main path's shape
        first = next(c for c in cases if c["dtype"] == torch.float32)
        bf = next(c for c in cases if c["dtype"] == torch.bfloat16)
        n_bf = launches["bfloat16"][name]
        row = {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
               "entry": first["entry"], "launches": launches["float32"][name],
               "max_abs_err": max(c["err"] for c in cases if c["dtype"] == torch.float32),
               **figures(first),
               "bfloat16": {"route": "cuda", "source": TC_SOURCES.get(bf["entry"], k.source),
                            "entry": bf["entry"], "launches": n_bf,
                            "tensor_core_launches": tc["bfloat16"].get(name, 0),
                            "max_abs_err": max(c["err"] for c in cases
                                               if c["dtype"] == torch.bfloat16),
                            **figures(bf)}}
        if name == "strip_warp_sum":
            # the blend beside the composition it replaced and the same
            # composition over grid_sample, both dtypes of the faces
            for c, d in ((first, row), (bf, row["bfloat16"])):
                d.update(case=c["case"], before_ms=c["before_ms"],
                         before_device_ms=c["before_device_ms"],
                         library_device_ms=c["library_device_ms"])
        if name == "warp_banded":
            # K1's launches by C entry on the 2D path, and every case of
            # phase 3 with its launches on the main paths (phases 4, 6, 9,
            # 11 and 13)
            row["routes"] = k1_routes["float32"]
            row["bfloat16"]["routes"] = k1_routes["bfloat16"]
            row["cases"] = [
                {"shape": c["shape"], "dtype": _dname(torch, c["dtype"]), "band": c["band"],
                 "flows": c["flows"], "entry": c["entry"], "max_abs_err": c["err"],
                 "device_by": c["device_by"],
                 "main_path_launches": sum(n for (sh, dn, bd, _), n in k1.counts.items()
                                           if (list(sh), dn, bd) == (c["shape"],
                                                                     _dname(torch, c["dtype"]),
                                                                     c["band"])),
                 **figures(c)} for c in cases]
        if name == "front_conv":
            # K3's three layers, each in both dtypes (its first three cases
            # per dtype are layers 0, 1 and 2 of the main path)
            per = {d: [c for c in cases if c["dtype"] == d][:3]
                   for d in (torch.float32, torch.bfloat16)}
            row["layers"] = [
                {"layer": i, "shape": f32["shape"],
                 "float32": {"entry": f32["entry"], **figures(f32)},
                 "bfloat16": {"entry": b16["entry"],
                              "source": TC_SOURCES.get(b16["entry"], k.source),
                              **figures(b16)}}
                for i, (f32, b16) in enumerate(zip(per[torch.float32], per[torch.bfloat16]))]
        rows.append(row)
    log(f"fps 1080p float32 {fps['float32']:.3f} bfloat16 {fps['bfloat16']:.3f}")
    log(f"fps VR {VR_FACE}^2 faces float32 {vr_fps['float32']:.3f} "
        f"({vr_fps['float32_no_png']:.3f} without PNG) bfloat16 {vr_fps['bfloat16']:.3f} "
        f"({vr_fps['bfloat16_no_png']:.3f} without PNG)")
    log(f"fps 1080p batched x{BATCH_N} float32 {b_fps['float32']:.3f} "
        f"({b_fps_no_png['float32']:.3f} without PNG) bfloat16 {b_fps['bfloat16']:.3f} "
        f"({b_fps_no_png['bfloat16']:.3f} without PNG)")
    log(f"fps 1080p feature reuse 3 float32 {r_fps['reuse']:.3f} "
        f"({r_fps['reuse_no_png']:.3f} without PNG; the exact run {fps['float32']:.3f}); "
        f"scale 0.5 float32 {r_fps['scale']:.3f}")
    log(f"evaluation: scorer {ev_ms['scorer_ms']:.3f} ms per 1080p frame (whole row "
        f"{ev_ms['row_ms']:.3f}), {ff['scorer_face_ms']:.3f} ms per {VR_FACE}^2 face; evaluator "
        f"fixture max relative error {eval_worst:.3g}; make_opt_flow {ff['make_opt_flow_s']:.3f} s "
        f"for {ff['pairs']} pairs, stylize_vr_video_file {ff['vr_file_s']:.3f} s for {EQUI_FRAMES} frames; "
        f"phases 11-13 took {t_new:.1f} s; {smi}")
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
