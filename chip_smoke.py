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
     beside the same composition over 24 grid_sample calls. K6, the
     folded upsample conv (float32 only), against its plain version at the
     canonical net's four tail shapes (layers 9 and 11 at 1080p and on a
     924-px face), beside cuDNN's conv of the upsampled input, with the
     bounds of its folded and of the unfolded operations; then the
     canonical net's stylizer (seeded weights) at 1080p and on a face: two
     K6 launches a call in float32, none in bfloat16, the kernel path
     against the plain path (the demo model of phases 4-20 upsamples by
     learned full convs, so those phases count no K6 launch). K2 and K4 in
     bfloat16 are bit-identical with their packed weights and rounded bias
     cached and packed afresh, with the host microseconds per call of
     both. K1 takes the C entry ops/warp_kernel.py's warp_route names
     (fav_warp_banded for C <= 4, fav_warp_banded_vec otherwise), each
     case beside grid_sample; after phase 16, K1 also runs at every (shape,
     dtype, band) that phases 4, 6, 9, 11, 13 and 16 launched and this list
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
     recorded by shape as those of phases 4, 6 and 9 are;
 14. the style trainer at full width (canonical architecture, 256x256,
     batch 4, phase 11's VGG-16, the bundled candy style at 384 px,
     shift:1,zoom_out:1,vr:1, one step then two from iteration 5, 10
     iterations, validation and a checkpoint every 5) on seeded images,
     float32 then bfloat16: finite losses, every parameter leaf moved, each
     forward-only pass launches K4 exactly 10 times on the entry conv_route
     names for the dtype and the gradient pass and backward launch no
     kernel, K4's total equal to 10 per forward-only pass of the batches
     the wheel drew; a fresh trainer restored at iteration 5 continues to
     10 beside the uninterrupted run (RESUME_LIMITS: losses rtol 5e-5
     float32, 5e-4 bfloat16, each parameter leaf within a share of its
     update since the checkpoint, the cancelled biases within Adam's 2 lr
     a step: cuDNN's and cuBLAS's default algorithms need not be
     deterministic), and two planted faults (Adam afresh, the data
     generator from its seed) must miss those limits; then the same resume
     under torch.use_deterministic_algorithms(True) must be bit-identical
     (deterministic_resume); the iteration time (CUDA events,
     median of the last 5) split into forward-only passes, gradient pass
     and optimizer, images per second, peak memory and the bound from the
     operations FlopCounterMode counts. Where h5py is installed, 2
     iterations from an HDF5 written by the port's make_image_dataset;
 15. the trainer in float32 on the card against the JAX trainer's fixture
     (tests/fixtures/torch_parity_train.npz: canonical architecture, 64x64,
     batch 2, 3 iterations, seeded parameters): losses rtol 1e-4, gradient
     norms rtol 2e-3, final parameter sums 2e-5 (check_train_parity);
 16. train_flow_synthetic from the bundled flow weights (256-px crops,
     batch 4, 20 iterations) with no kernel launch, its step time; then
     evaluate_heldout on the bundled weights through K1 against the JAX
     function's fixture (tests/fixtures/torch_parity_flow_eval.npz), EPE
     rtol 1e-4, pass rates within 1e-3; K1's launches recorded by shape.
     K4's launches in phases 14 and 15 are recorded by shape too, and after
     phase 16 phase 3 holds K4 against its plain version at each of them
     on the inputs of its first launch (relative L2 1e-4 float32, 1e-2
     bfloat16).
 17-20. several cards, at each of 1, 2 and 4 cards the machine has (the
     others are printed as not run): 17. the serving pool
     (video/serving.py) over c cards, 2 streams a card of the 1080p pan,
     float32 then bfloat16, one host thread, and one thread per card at the
     largest count (run_serving: launches, placement, each stream against
     its solo run, frames/s and each card's busy share); 18. data-parallel training at
     world 1, 2 and 4, one NCCL process a card (two gloo ranks on card 0 on
     a one-card machine: the contract only), float32 then bfloat16
     (run_data_parallel: gradients against world 1, bit-identical resume,
     equal ranks, the restore onto world 1, images/s and scaling); 19. the
     1080p frame height-sharded over 2 and 4 cards (2 shards on card 0 on
     one card) against the unsharded forward, and a 4K forward on one card
     (run_spatial); 20. dryrun_multichip on every card. With the single
     argument --cards-only the script runs phases 1-2 and 17-20 alone and
     prints no result line.

The last lines of standard output are the card's name and power limit, a
JSON line with one row per kernel (name, route, source, the TPU kernel it
replaces, its float32 C entry, launches in its main path's float32 run (K4
also its launches in phase 14's runs, "training_launches", and its cases at
the training shapes, "training_cases"), max
abs error, kernel, device, plain, bound and library-call milliseconds, and
under "bfloat16" the same figures of its bfloat16 form: route, source, C
entry, launches in the bfloat16 run and how many of them took the tensor
cores; K3's row also lists its three layers under "layers", each with its
shape and both dtypes' C entry and figures) and {"ok": true, "device":
{...}}. K5's summing entry has a row of its own ("strip_warp_sum": the
cross-face blend, with the times of the composition it replaced and of the
same composition over grid_sample); K6's row ("upsample_conv") lists its
four cases with their unfolded bounds and the canonical net's launches and
times ("canonical"); K1's row lists its launches by C entry
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
           "fav_strip_warp_sum": "strip_warp_sum_kernel", "fav_upconv_f32": "upconv_f32_kernel"}
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
    """{name: Kernel} of every hand-written kernel (K1-K6)."""
    from fast_artistic_videos_tpu_torch.ops import (conv_kernel, front_kernel, rblock_kernel,
                                                    strip_warp_kernel, upconv_kernel,
                                                    warp_kernel)

    return {k.name: k for k in (warp_kernel.KERNEL, rblock_kernel.KERNEL, front_kernel.KERNEL,
                                conv_kernel.KERNEL, strip_warp_kernel.KERNEL,
                                upconv_kernel.KERNEL)}


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


class LaunchShapes:
    """One kernel's launches on the main paths by a key of their shape, and
    the arguments of the first launch of each key, kept on the card for
    phase 3's continuation. `recording()` wraps the kernel's public
    entries (`ENTRY_NAMES` of `MODULE`), here in the script and not in the
    package, for one run (the flow thread launches too, hence the lock);
    `check` holds that run's record against the kernel's own counters. A
    call made while the flow provider captures a step (`flow.graphs`)
    launches once the graph before it has run, so its inputs hold no
    values when the call is made: a later call of its key keeps them (the
    step's replays call the entry again). A subclass names the entries and
    the key, whose last item is the C entry the launch takes."""

    MODULE, ENTRY_NAMES = "", ()

    def __init__(self):
        import threading

        self.counts, self.inputs, self.run = {}, {}, {}
        self._lock = threading.Lock()

    def key(self, entry_name, *args):
        raise NotImplementedError

    @contextlib.contextmanager
    def recording(self):
        import importlib

        import torch

        mod = importlib.import_module(self.MODULE)
        fns = {name: getattr(mod, name) for name in self.ENTRY_NAMES}
        self.run = {}

        def wrap(name, fn):
            def wrapped(*args):
                if args[0].device.type == "cuda":
                    key = self.key(name, *args)
                    with self._lock:
                        self.run[key] = self.run.get(key, 0) + 1
                        if key not in self.inputs and \
                                not torch.cuda.is_current_stream_capturing():
                            self.inputs[key] = tuple(
                                a.detach().clone() if hasattr(a, "detach") else a
                                for a in args)
                return fn(*args)
            return wrapped
        for name, fn in fns.items():
            setattr(mod, name, wrap(name, fn))
        try:
            yield self
        finally:
            for name, fn in fns.items():
                setattr(mod, name, fn)
            for key, n in self.run.items():
                self.counts[key] = self.counts.get(key, 0) + n

    def check(self, kernel, where):
        """Log the last run's record; raise unless it sums to the kernel's
        launches and its C entries to the kernel's routes."""
        by_entry = {}
        for key, n in self.run.items():
            by_entry[key[-1]] = by_entry.get(key[-1], 0) + n
        for key, n in sorted(self.run.items()):
            log(f"{kernel.name} shape {where}: {key}: {n} launches")
        if sum(self.run.values()) != kernel.launches or by_entry != kernel.routes:
            raise AssertionError(f"{where}: {kernel.name} record {by_entry} != launches "
                                 f"{kernel.launches} by entry {kernel.routes}")


class WarpShapes(LaunchShapes):
    """K1's launches on the main paths (phases 4, 6, 9, 11, 13 and 16) by
    (shape, dtype, band, C entry): phase 3 adds a case for each shape its
    own list lacks, and times K1 on the flows the main paths produced
    (their taps lie close together) beside its seeded random flows (whose
    taps scatter over the whole band)."""

    MODULE = "fast_artistic_videos_tpu_torch.ops.warp_kernel"
    ENTRY_NAMES = ("warp_banded",)

    def key(self, entry_name, img, flow, band):
        from fast_artistic_videos_tpu_torch.ops import warp_kernel

        entry = warp_kernel.warp_route(img.shape[-1], img.dtype, img.data_ptr() % 16 == 0)[0]
        return tuple(img.shape), str(img.dtype).split(".")[-1], int(band), entry


class ConvShapes(LaunchShapes):
    """K4's launches on the training paths (phases 14 and 15) by (input
    shape, dtype, Cout, pad, ReLU, C entry): phase 3 holds K4 against its
    plain version at each of them, on the inputs of its first launch."""

    MODULE = "fast_artistic_videos_tpu_torch.ops.conv_kernel"
    ENTRY_NAMES = ("conv3x3", "conv3x3_valid")

    def key(self, entry_name, x, w, b, relu=False):
        from fast_artistic_videos_tpu_torch.ops import _conv_in

        pad = 1 if entry_name == "conv3x3" else 0
        entry = _conv_in.conv_route(x.dtype, 3, 3, 1, pad, x.shape[-1], w.shape[0])
        return (tuple(x.shape), str(x.dtype).split(".")[-1], int(w.shape[0]), pad, bool(relu),
                entry)


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
    band) that phases 4, 6, 9, 11, 13 and 16 launched and phase 3's list lacks, on
    seeded random flows, then at every one of them on the inputs of its
    first launch there (kept by a call outside a graph capture)."""
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
        if key not in k1.inputs:
            # called only while a step was captured: held above on seeded flows
            log(f"K1 {key}: no main-path inputs kept (called only in graph captures)")
            continue
        warp_cases(torch, g, res["warp_banded"], shape, band, dtypes[dname],
                   1e-5 if dname == "float32" else 2 ** -7, inputs=k1.inputs[key][:2])


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
    res["upsample_conv"], res["canonical_tail"] = check_upconv(torch, g)
    check_bf16_packs(torch, g)
    return res


def check_block_conv(torch, g):
    """K4 against its plain version: the batched 1080p residual-block conv
    (4, 290, 500, 128) -> 128 VALID in float32 and bfloat16, and a SAME
    (pad 1) conv widening to 256 with the ReLU epilogue (block_conv_case)."""
    out = []
    for n, h, w, cin, cout, same, relu, dtype in (
            (4, 290, 500, 128, 128, False, False, torch.float32),
            (4, 290, 500, 128, 128, False, False, torch.bfloat16),
            (2, 64, 96, 128, 256, True, True, torch.float32),
            (2, 64, 96, 128, 256, True, True, torch.bfloat16)):
        x = torch.randn(n, h, w, cin, generator=g).to("cuda", dtype)
        wt = (torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        block_conv_case(torch, out, x, wt, b, relu, same, "block conv")
    return out


# the canonical net's two folds (layer 9: 3x3 128 -> 64 after a U2; layer
# 11: 9x9 64 -> 3 after a U2, then tanh * 150) at 1080p and on a 922-px face
# (padded to 924): (label, low-resolution input shape, k, Cout, last layer)
UPCONV_CASES = (("1080p layer 9", (1, 270, 480, 128), 3, 64, False),
                ("1080p layer 11", (1, 540, 960, 64), 9, 3, True),
                ("face layer 9", (1, 231, 231, 128), 3, 64, False),
                ("face layer 11", (1, 462, 462, 64), 9, 3, True))


def check_upconv(torch, g):
    """K6 against its plain version (cuDNN's float32 conv of the folded
    weights) at UPCONV_CASES, with the upsample's norm affine and ReLU in
    the prologue: max abs <= 2e-5 of the output's max abs, the statistics
    to rtol 1e-4; CUDA-event, device (profiler), plain and library times
    (cuDNN's conv of the upsampled input alone, the conv the fold replaced),
    the bound of the folded operations and that of the unfolded ones. Then
    the canonical net (seeded weights; the demo model upsamples by learned
    full convs and never takes K6) at 1080p and on a 924-px face: two K6
    launches a call in float32 and none in bfloat16, the kernel path against
    the plain (cuDNN) path (max-abs/255 <= 1e-3 float32, mean-abs/255 <= 1e-2
    bfloat16) and both paths' times. Returns (cases, {where: {dtype:
    figures}})."""
    from fast_artistic_videos_tpu_torch.models import arch_dsl, stylizer
    from fast_artistic_videos_tpu_torch.ops import upconv_kernel as uk

    k6 = uk.KERNEL
    out = []
    for label, shape, k, cout, last in UPCONV_CASES:
        n, h, w, cin = shape
        x = torch.randn(*shape, generator=g).cuda()
        wt = (torch.randn(cout, cin, k, k, generator=g) / (k * k * cin) ** 0.5).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).cuda()
        eff = torch.stack([torch.rand(n, cin, generator=g) + 0.5,
                           torch.randn(n, cin, generator=g)], dim=1).cuda()
        kw = dict(eff=eff, relu=True, stats=not last, tanh_scale=150.0 if last else None)
        before = k6.routes.get(uk.ENTRY, 0)
        got = uk.upconv(x, wt, b, **kw)
        want = uk.upconv_plain(x, wt, b, **kw)
        torch.cuda.synchronize()
        if k6.routes.get(uk.ENTRY, 0) != before + 1:
            raise AssertionError(f"K6 {label}: the launch did not take {uk.ENTRY}")
        y, yp = (got, want) if last else (got[0], want[0])
        err, top = (y - yp).abs().max().item(), yp.abs().max().item()
        stats_ok = last or bool(torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-3))
        ms = _time_ms(torch, lambda: uk.upconv(x, wt, b, **kw))
        dev_ms = _profile_ms(torch, lambda: uk.upconv(x, wt, b, **kw), SYMBOLS[uk.ENTRY])
        plain_ms = _time_ms(torch, lambda: uk.upconv_plain(x, wt, b, **kw))
        up = x.permute(0, 3, 1, 2).repeat_interleave(2, 2).repeat_interleave(2, 3).contiguous()
        lib_ms = _time_ms(torch, lambda: torch.nn.functional.conv2d(up, wt, b, 1, (k - 1) // 2))
        del up
        taps = uk.fold_window(k)[2] ** 2
        nbytes = ((x.numel() + y.numel()) * 4 + len(uk.tap_phases(k)) * cin * cout * 4
                  + (0 if last else 2 * cout * 4))
        b_ms, b_by = bound(nbytes, 2 * 4 * taps * cin * cout * n * h * w, "float32")
        u_ms, _ = bound(nbytes, 2 * k * k * cin * cout * y.shape[1] * y.shape[2] * n, "float32")
        desc = f"{label} {shape}->{cout} k{k}"
        log(f"upsample_conv {desc} via {uk.ENTRY}: max_abs {err:.3g} (tol {2e-5 * top:.3g}, "
            f"2e-5 of max {top:.4g}) stats ok {stats_ok} kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms, profiler) plain {plain_ms:.4f} ms cuDNN conv of the upsampled "
            f"input {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, folded) unfolded bound "
            f"{u_ms:.4f} ms")
        if not (err <= 2e-5 * top and stats_ok):
            raise AssertionError(f"upsample_conv {desc}: max abs {err} > 2e-5 x {top} or "
                                 f"statistics off")
        out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=torch.float32, bound_ms=b_ms,
                        bound_by=b_by, unfolded_bound_ms=u_ms, library_ms=lib_ms,
                        device_ms=dev_ms, entry=uk.ENTRY, shape=desc))
    spec = arch_dsl.parse_arch("canonical")
    params = stylizer.init_params(torch.Generator(device="cuda").manual_seed(17), spec,
                                  device="cuda")
    canon = {}
    face = -(-VR_FACE // 4) * 4                     # the stride-padded face
    for where, (h, w) in (("1080p", SIZE_1080), ("face", (face, face))):
        x = torch.randn(1, h, w, 7, generator=g).cuda() * 60
        canon[where] = {}
        for dtype in (torch.float32, torch.bfloat16):
            xd, res = x.to(dtype), {}

            def run(fused):
                res[fused] = stylizer.apply(params, spec, xd, fused=fused)
            with torch.no_grad():
                before = k6.launches
                run(True)
                launched = k6.launches - before
                run(False)
                diff = (res[True].float() - res[False].float()).abs() / 255.0
                t_k = _time_ms(torch, lambda: run(True), n=8)
                t_p = _time_ms(torch, lambda: run(False), n=8)
            f32 = dtype == torch.float32
            err, tol = (diff.max().item(), 1e-3) if f32 else (diff.mean().item(), 1e-2)
            want_n = 2 if f32 else 0
            log(f"canonical net {where} ({h}x{w}) {_dname(torch, dtype)}: K6 launches "
                f"{launched} (expected {want_n}); kernel path {t_k:.3f} ms, plain cuDNN path "
                f"{t_p:.3f} ms; {'max' if f32 else 'mean'}-abs/255 {err:.3g} (tol {tol:g})")
            if launched != want_n or not err <= tol:
                raise AssertionError(f"canonical net {where} {dtype}: K6 launches {launched} "
                                     f"!= {want_n} or kernel vs plain path {err} > {tol}")
            canon[where][_dname(torch, dtype)] = {"launches": launched, "ms": t_k,
                                                  "plain_ms": t_p, "err": err}
    return out, canon


def block_conv_case(torch, out, x, wt, b, relu, same, where):
    """One K4 case on (x, wt, b): the kernel against its plain version,
    relative L2 <= 1e-4 float32, <= 1e-2 bfloat16 (the conv_case
    tolerances), with CUDA-event, device (profiler), plain, bound and
    F.conv2d (cuDNN, on the same NHWC data) times; appended to out."""
    from fast_artistic_videos_tpu_torch.ops import _conv_in, conv_kernel

    n, h, w, cin = x.shape
    cout, dtype, pad = wt.shape[0], x.dtype, 1 if same else 0
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
    try:
        dev_ms, dev_by = _profile_ms(torch, lambda: fn(x, wt, b, relu), SYMBOLS[entry],
                                     tries=5), "profiler"
    except RuntimeError as e:
        log(f"K4 {where} {tuple(x.shape)} {dtype}: {e}; device time from a CUDA graph instead")
        dev_ms, dev_by = _graph_ms(torch, lambda: fn(x, wt, b, relu)), "CUDA graph"
    plain_ms = _time_ms(torch, lambda: conv_kernel.conv3x3_plain(x, wt, b, relu, pad))
    xc, wc, bc = x.permute(0, 3, 1, 2), wt.to(dtype), b.to(dtype)
    lib_ms = _time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, 1, pad))
    esz = x.element_size()
    nbytes = (x.numel() + y.numel() + wt.numel()) * esz + b.numel() * 4
    flops = 2 * y.shape[0] * y.shape[1] * y.shape[2] * cout * cin * 9
    b_ms, b_by = bound(nbytes, flops, _dname(torch, dtype))
    shape = f"({n},{h},{w},{cin})->{cout} {'SAME' if same else 'VALID'}"
    log(f"K4 {where} {shape} relu={relu} {dtype} via {entry}: rel_l2 {rel:.3g} max_abs "
        f"{err:.3g} (tol {tol:g}) kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {dev_by}) plain "
        f"{plain_ms:.4f} ms conv2d {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
        f"{flops / 1e9:.2f} GFLOP)")
    if not rel <= tol:
        raise AssertionError(f"K4 {where} {shape} {dtype}: rel {rel}")
    out.append(dict(err=err, ms=ms, plain_ms=plain_ms, dtype=dtype, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms, entry=entry,
                    shape=shape, relu=relu, rel_l2=rel, where=where, device_by=dev_by))


def check_recorded_convs(torch, res, k4):
    """Phase 3, continued after the training paths: K4 at every (input
    shape, dtype, Cout, pad, ReLU) that phases 14 and 15 launched, on the
    inputs of its first launch there (block_conv_case)."""
    for key in sorted(k4.counts):
        x, w, b, *relu = k4.inputs[key]
        block_conv_case(torch, res["conv3x3"], x, w, b, bool(relu and relu[0]), key[3] == 1,
                        f"training ({k4.counts[key]} launches)")


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
    # check's sample; K6 none: the demo model upsamples by learned full
    # convs, which the folded upsample conv does not take
    expect = {"front_conv": 3 * n, "res_chain_conv": 10 * n, "warp_banded": pairs * (1 + 6 + 1),
              "conv3x3": 0, "strip_warp": 0, "upsample_conv": 0}
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
              "warp_banded": 18 * (n - 1), "conv3x3": 0, "upsample_conv": 0}
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
              "warp_banded": 7 * pairs + pairs + reuse, "conv3x3": 0, "strip_warp": 0,
              "upsample_conv": 0}
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
              "conv3x3": 0, "strip_warp": 0, "upsample_conv": 0}
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
              "conv3x3": 0, "strip_warp": 0, "upsample_conv": 0}
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
              "warp_banded": 18 * (nv - 1), "conv3x3": 0, "upsample_conv": 0}
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


# ---------------------------------------------------------------------------
# phases 14-16: training
# ---------------------------------------------------------------------------

TRAIN_SIZE, TRAIN_BATCH, TRAIN_ITERS, TRAIN_IMAGES = 256, 4, 10, 12
TRAIN_IMAGE_SEED = 20261022
# the trainer fixture's seeds, sizes and options: tools/make_torch_parity_fixture.py's
# write_train runs the JAX trainer with them, phase 15 the port's. The
# learning rate is 1e-5: Adam's first steps move every element by about
# the learning rate whatever its gradient's size, and at the default 1e-3
# the run's own float32 and float64 losses part by 1e-3 by iteration 3
# (at 1e-5: 4e-6), which no float32 comparison could resolve
PARITY_PARAM_SEED, PARITY_IMAGE_SEED = 20261020, 20261021
PARITY_HW, PARITY_BATCH, PARITY_ITERS, PARITY_IMAGES = 64, 2, 3, 6
PARITY_OPTS = dict(data_mix="shift:1,zoom_out:1", train_img_size=f"{PARITY_HW}:{PARITY_HW}",
                   batch_size=PARITY_BATCH, style_image_size=PARITY_HW, learning_rate="1e-5",
                   num_iterations=PARITY_ITERS, print_every=10 ** 9, history_every=1,
                   checkpoint_every=10 ** 9, images_every=0, num_val_batches=1)
PARITY_LR = 1e-5
FLOW_TRAIN_SIZE, FLOW_TRAIN_BATCH, FLOW_TRAIN_ITERS, FLOW_TRAIN_POOL = 256, 4, 20, 16


class ArraySource:
    """An in-memory image source with the duck type of the trainer's
    H5ImageSource (next_images, reset, cursor): {split: (N, H, W, 3)
    uint8}, batches of batch_size in order, wrapping before a short one
    (also the JAX trainer's source in tools/make_torch_parity_fixture.py)."""

    def __init__(self, images, batch_size):
        self.images, self.batch_size = images, batch_size
        self.cursor = {k: 0 for k in images}

    def reset(self, split):
        self.cursor[split] = 0

    def next_images(self, split):
        import numpy as np

        n, start = len(self.images[split]), self.cursor[split]
        if start + self.batch_size > n:
            start = 0
        end = start + self.batch_size
        self.cursor[split] = 0 if end >= n else end
        return self.images[split][start:end].astype(np.float32) / 255.0


def seeded_images(seed, n, hw):
    """{"train", "val"}: n seeded uint8 (hw, hw, 3) images each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {split: rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
            for split in ("train", "val")}


def seeded_params(seed, shapes):
    """A stylizer tree in the JAX package's layout from a numpy seed (both
    sides of the trainer fixture start from it), leaves in sorted flat-key
    order: kernels (HWIO) uniform in (-s, s), s = 1/sqrt(kh kw Cin), biases
    uniform in (-0.05, 0.05), norm scales uniform in (0.5, 1.5)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tree = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        leaf = key.rsplit("/", 1)[1]
        if leaf == "w":
            s = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-s, s, shape)
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.uniform(-0.05, 0.05, shape)
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = a.astype(np.float32)
    return tree


def flat_tree(tree, prefix=""):
    """{"layer00/w": array, ...} of a nested parameter tree."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def train_parity_run(torch, device, vgg_path):
    """The port's side of phase 15 (also run on the CPU by
    tests/test_torch_train.py): the run of write_train on `device`.
    Returns (losses, {key: first-iteration gradient L2 norm}, {key: final
    parameters}, {key: initial parameters}), keys and layout the JAX
    package's."""
    import copy

    import numpy as np
    from fast_artistic_videos_tpu_torch.core import device as device_mod
    from fast_artistic_videos_tpu_torch.core.config import TrainOptions, schedule_value
    from fast_artistic_videos_tpu_torch.models import checkpoint, registry
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer, leaves
    from fast_artistic_videos_tpu_torch.video.evaluation import load_vgg_params

    opt = TrainOptions(style_image=registry.style_fixture("candy"), **PARITY_OPTS)
    tr = Trainer(opt, vgg_params=load_vgg_params(vgg_path, device), device=device)
    tr.image_source = ArraySource(seeded_images(PARITY_IMAGE_SEED, PARITY_IMAGES, PARITY_HW),
                                  PARITY_BATCH)
    keys = list(flat_tree(checkpoint.params_to_numpy(tr.params)))   # leaves() order
    init = seeded_params(PARITY_PARAM_SEED, {k: v.shape for k, v in flat_tree(
        checkpoint.params_to_numpy(tr.params)).items()})
    tr.set_params(init)
    # the first iteration's gradient, from the batch the run draws first
    state = copy.deepcopy(tr.data_rng.bit_generator.state)
    cursor = dict(tr.image_source.cursor)
    source = tr._next_source()
    imgs, flows, certs, steps = tr._get_batch(
        "train", source, int(schedule_value(tr.frame_steps_sched, 1)))
    with device_mod.float32_convs():
        loss, _ = tr._loss_fn(tr.params, imgs, flows, certs, steps, tr._first_mode(source))
        grads = torch.autograd.grad(loss, leaves(tr.params))
    tr.data_rng.bit_generator.state = state
    tr.image_source.cursor = cursor
    tr.train(log_fn=lambda *a: None)
    norms = {k: float(g.double().norm()) for k, g in zip(keys, grads)}
    return (np.asarray(tr.train_loss_history, np.float64), norms,
            flat_tree(checkpoint.params_to_numpy(tr.params)), flat_tree(init))


def check_train_parity(fx, run):
    """Phase 15's comparison of a port run (train_parity_run) with the JAX
    trainer's fixture. Tolerances:
      * losses, rtol 1e-4 (iteration 1: the same parameters and batch;
        iterations 2-3 after Adam steps at lr 1e-5, where this run's own
        float32 and float64 losses part by 4e-6);
      * first-iteration gradient norms, rtol 2e-3, for the leaves whose
        norm is at least 1e-6 of the largest (float32 gradients of this
        arithmetic carry 2e-3 to 7e-3 relative error against float64, the
        instance norm's one-pass variance amplifying each side's rounding;
        the two packages part by 2e-4 to 4.3e-4 here); the leaves below
        that are the conv biases that instance norm cancels, whose exact
        gradient is 0: the port's norm must be below 1e-6 of its largest
        too;
      * final parameters, per-leaf sum and sum of absolute values within
        2e-5 of the reference's sum of absolute values (measured: up to
        3.4e-6; Adam moves the elements whose gradient is at the noise
        floor by noise, 2 lr at most per step); for the cancelled
        biases, whose Adam updates follow float noise, within Adam's bound
        of 2 lr per element per iteration.
    Returns the worst relative figures {"loss", "grad_norm", "param"};
    raises on a miss."""
    import numpy as np

    losses, norms, final, init = run
    want = np.asarray(fx["losses"])
    rel_loss = np.abs(losses - want) / np.abs(want)
    if losses.shape != want.shape or not (rel_loss <= 1e-4).all():
        raise AssertionError(f"train parity: losses {losses} vs {want}")
    top = max(float(fx[f"grad_norm/{k}"]) for k in norms)
    top_port = max(norms.values())
    worst_g, worst_p, noise = 0.0, 0.0, []
    for k, got in norms.items():
        ref = float(fx[f"grad_norm/{k}"])
        p = final[k].astype(np.float64)
        s, a = float(fx[f"param_sum/{k}"]), float(fx[f"param_abs/{k}"])
        if ref < 1e-6 * top:
            noise.append(k)
            bound = 2 * PARITY_LR * PARITY_ITERS * p.size
            if not (got < 1e-6 * top_port and abs(p.sum() - s) <= bound
                    and abs(np.abs(p).sum() - a) <= bound):
                raise AssertionError(f"train parity: cancelled leaf {k}: norm {got} vs {ref}, "
                                     f"sums {p.sum()} / {np.abs(p).sum()} vs {s} / {a}")
            continue
        rel_g = abs(got - ref) / ref
        rel_p = max(abs(p.sum() - s), abs(np.abs(p).sum() - a)) / a
        worst_g, worst_p = max(worst_g, rel_g), max(worst_p, rel_p)
        if rel_g > 2e-3 or rel_p > 2e-5:
            raise AssertionError(f"train parity: {k}: gradient norm {got} vs {ref} "
                                 f"({rel_g:.3g}), final params off by {rel_p:.3g}")
    log(f"train parity: losses {losses.tolist()} vs JAX {want.tolist()} (max rel "
        f"{rel_loss.max():.3g}, tol 1e-4); gradient norms max rel {worst_g:.3g} (tol 2e-3) "
        f"over {len(norms) - len(noise)} leaves; final params max rel {worst_p:.3g} (tol 2e-5); "
        f"{len(noise)} cancelled biases within Adam's bound")
    return {"loss": float(rel_loss.max()), "grad_norm": worst_g, "param": worst_p}


class TrainProbe:
    """Phase 14's instrumentation of one trainer, in this script: it wraps
    the trainer's step methods (instance attributes over the class's) to
    count each kernel's launches around every stylizer pass and backward,
    and to time the parts of each train step on CUDA events. A
    forward-only pass (``_model`` with grad False) must launch K4 exactly
    10 times (the five residual blocks' two convs at batch 4) on the C
    entry conv_route names for the dtype, and no other kernel; the
    gradient pass (``_model`` with grad True, and ``_backward``) must
    launch none."""

    def __init__(self, torch, trainer, kernels, dname):
        self.torch, self.kernels, self.entry = torch, kernels, ENTRIES[dname]["conv3x3"]
        self.batches, self.iters, self.passes = [], [], {True: 0, False: 0}
        self._cur = None
        for name in ("_get_batch", "_model", "_loss_fn", "_backward", "_optimizer_step",
                     "_train_step"):
            setattr(trainer, name, self._wrap(name, getattr(trainer, name)))

    def _event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _counts(self):
        return {n: (k.launches, dict(k.routes)) for n, k in self.kernels.items()}

    def _check(self, name, grad, before, after):
        want = dict(before)
        if not grad:
            n, routes = before["conv3x3"]
            routes = dict(routes)
            routes[self.entry] = routes.get(self.entry, 0) + 10
            want["conv3x3"] = (n + 10, routes)
        if after != want:
            raise AssertionError(f"training {name} (grad {grad}): launches {after}, "
                                 f"expected {want}")
        self.passes[grad] += 1

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            if name == "_get_batch" and a[0] == "train":
                self._cur = {"start": self._event(), "fwd": [], "fwd_shapes": [], "loss": [],
                             "bwd": [], "opt": []}
            before = self._counts()
            s = self._event()
            out = fn(*a, **kw)
            e = self._event()
            grad = kw["grad"] if "grad" in kw else a[2] if name == "_model" else None
            if name == "_get_batch":
                self.batches.append((a[0], a[1], out[3]))
            elif name == "_model":
                self._check(name, grad, before, self._counts())
            elif name == "_backward":
                self._check(name, True, before, self._counts())
            cur = self._cur
            if cur is not None:
                if name == "_model" and not grad:
                    cur["fwd"].append((s, e))
                    cur["fwd_shapes"].append(tuple(a[1].shape))
                elif name in ("_loss_fn", "_backward", "_optimizer_step"):
                    cur[{"_loss_fn": "loss", "_backward": "bwd",
                         "_optimizer_step": "opt"}[name]].append((s, e))
                elif name == "_train_step":
                    cur["step"], cur["end"] = s, e
                    self.iters.append(cur)
                    self._cur = None
            return out
        return wrapped

    def expected_k4(self):
        """K4's launches the recorded batches need: 10 per forward-only
        pass, i.e. per train batch frame 1 (unless single_image) and the
        steps before the last, per validation batch frame 1 and every step."""
        n = 0
        for split, source, steps in self.batches:
            n += (source != "single_image") + (steps - 1 if split == "train" else steps)
        return 10 * n

    def times(self, last):
        """Median ms over the last `last` iterations of the whole iteration
        (its batch, then its step), the batch (host sampling and the copy
        to the card), the forward-only passes, the gradient pass (forward
        and backward) and the optimizer step."""
        self.torch.cuda.synchronize()

        def ms(pairs):
            return sum(s.elapsed_time(e) for s, e in pairs)
        rows = [{"iteration": it["start"].elapsed_time(it["end"]),
                 "batch": it["start"].elapsed_time(it["step"]),
                 "forward_only": ms(it["fwd"]),
                 "gradient_pass": ms(it["loss"]) - ms(it["fwd"]) + ms(it["bwd"]),
                 "optimizer": ms(it["opt"])} for it in self.iters[-last:]]
        return {k: _median([r[k] for r in rows]) for k in rows[0]}


def _flops(fn):
    """Floating-point operations of fn() by torch's FlopCounterMode (convs
    and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def train_bound(torch, trainer, probe, last, dname):
    """The least time of the last `last` train iterations' work (mean ms
    per iteration) from their operations: each forward-only pass at the
    shape it ran, the last step's stylizer forward and backward (dX and
    dW), and the loss network's forward on the output, its dX backward and
    the content target's forward, Gram products included; counted by
    FlopCounterMode on the plain path (the kernels do the same convs). The
    stylizer's operations at the peak of its dtype, the loss network's
    (float32) at the float32 peak. Returns (bound ms, stylizer GFLOP,
    loss-network GFLOP) per iteration."""
    from fast_artistic_videos_tpu_torch.core import device as device_mod
    from fast_artistic_videos_tpu_torch.models import stylizer
    from fast_artistic_videos_tpu_torch.train import losses

    n, s, dev = TRAIN_BATCH, TRAIN_SIZE, trainer.device
    dtype = torch.bfloat16 if dname == "bfloat16" else torch.float32

    def trainable(tree):
        return {k: trainable(v) if isinstance(v, dict) else v.detach().clone().requires_grad_()
                for k, v in tree.items()}
    params = trainable(trainer.params)
    cache = {}

    def fwd(shape):
        if shape not in cache:
            x = torch.zeros(shape, device=dev)
            with torch.no_grad(), device_mod.float32_convs():
                cache[shape] = _flops(lambda: stylizer.apply(params, trainer.spec, x,
                                                             dtype=dtype, fused=False))
        return cache[shape]

    def grad_pass():
        x = torch.zeros((n, s, s, 7), device=dev)
        with device_mod.float32_convs():
            stylizer.apply(params, trainer.spec, x, dtype=dtype, fused=False).float().sum(
                ).backward()

    def loss_pass():
        out = torch.zeros((n, s, s, 3), device=dev, requires_grad=True)
        with device_mod.float32_convs():
            loss, _ = losses.perceptual_loss(trainer.vgg_params, out, out.detach(),
                                             trainer.style_tgts, trainer.percep_cfg)
            loss.backward()
    f_grad, f_loss = _flops(grad_pass), _flops(loss_pass)
    its = probe.iters[-last:]
    sty = sum(f_grad + sum(fwd(sh) for sh in it["fwd_shapes"]) for it in its) / len(its)
    ms = (sty / PEAK_FLOPS[dname] + f_loss / PEAK_FLOPS["float32"]) * 1e3
    return ms, sty / 1e9, f_loss / 1e9


def train_profile(torch, trainer, n):
    """n more iterations of `trainer` under torch.profiler (CUDA activity
    only): the device's kernel time per iteration (ms) and the 8 kernels
    with the most of it, (ms per iteration, name, launches per iteration)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.train(trainer.iteration + n, log_fn=lambda *a: None)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total", None)
        ms = (ms if ms is not None else getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            rows.append((round(ms / n, 3), ev.key[:60], ev.count // n))
    rows.sort(reverse=True)
    return {"device_ms": _device_events(prof)[0] / n, "top_kernels": rows[:8]}


def _param_copy(trainer):
    from fast_artistic_videos_tpu_torch.train.trainer import leaves

    return [t.detach().clone() for t in leaves(trainer.params)]


# phase 14's resume check. A trainer restored from the iteration-5
# checkpoint runs on to 10 beside the uninterrupted one. By default it
# need not match bit for bit on the card: cuDNN's and cuBLAS's default
# algorithms need not be deterministic (under
# torch.use_deterministic_algorithms the same resume is bit-identical in
# both dtypes, and deterministic_resume holds it so), so it is held to
# limits: the losses of iterations 6-10 relative to the uninterrupted
# run's, and each parameter leaf's distance from the uninterrupted run's,
# relative L2 to that run's update of the leaf since the checkpoint. The
# conv biases an instance norm follows have an exact gradient of 0 and
# move by float noise: Adam moves them by at most 2 lr an element a step
# (lr 1e-3, 5 steps). Each planted fault (RESUME_FAULTS, besides "" for
# the true resume) must miss a limit. Measured by this script in two runs
# on an H100 (80GB HBM3, 700 W): the true resume's losses within 1.1e-7 to
# 4.0e-6 (float32) and 2.9e-5 to 6.0e-5 (bfloat16), its leaves within
# 6.9e-5 to 4.7e-4 and 6.4e-4 to 1.6e-3; the planted faults' losses 0.13
# and more, their leaves 0.09 and more. The limits stand about 10x above
# the true resume's largest gap (the float32 gap moved 37x between the two
# runs) and at least 4.5x below the faults' smallest.
RESUME_LIMITS = {"float32": {"loss": 5e-5, "leaf": 5e-3},
                 "bfloat16": {"loss": 5e-4, "leaf": 2e-2}}
RESUME_CANCELLED_ABS = 2 * 1e-3 * (TRAIN_ITERS - TRAIN_ITERS // 2)
RESUME_FAULTS = ("", "fresh optimizer", "data generator from its seed")


def _plant(fault, trainer, opt):
    """Break a restored trainer's state as `fault` names ("" = none): Adam
    afresh (its moments and step count lost), or the data generator put
    back to its seed (the batches and the data-mix wheel drawn anew)."""
    import numpy as np

    if fault == "fresh optimizer":
        trainer.optimizer = trainer._make_optimizer()
    elif fault == "data generator from its seed":
        trainer.data_rng = np.random.default_rng(opt.seed + 1)


def cancelled_biases(spec):
    """The flat keys of the per-channel additive terms that an instance
    norm cancels, whose exact gradient is 0: the bias of every conv with a
    norm after it, both conv biases of a residual block, and the last
    additive term before a nearest upsample with a norm after it."""
    if not spec.use_instance_norm:
        return set()
    out = set()
    for i, layer in enumerate(spec.layers):
        if layer.kind == "res_block":
            out |= {f"layer{i:02d}/conv1/b", f"layer{i:02d}/conv2/b"}
        elif layer.kind == "upsample":
            prev = spec.layers[i - 1] if i else None
            if layer.norm_after and prev is not None:
                out.add(f"layer{i - 1:02d}/norm2/bias" if prev.kind == "res_block" else
                        f"layer{i - 1:02d}_norm/bias" if prev.norm_after else
                        f"layer{i - 1:02d}/b")
        elif layer.norm_after:
            out.add(f"layer{i:02d}/b")
    return out


def resume_gap(a, r, at_ck, half, cancelled):
    """How far the restored trainer r's run strays from the uninterrupted
    a's over iterations half+1 on: the losses' largest relative gap, the
    largest per-leaf relative L2 distance (to a's update since the
    checkpoint, at_ck being r's parameters there) over the leaves that are
    not cancelled biases, and the cancelled biases' largest element gap."""
    from fast_artistic_videos_tpu_torch.models import checkpoint

    keys = list(flat_tree(checkpoint.params_to_numpy(a.params)))   # leaves() order
    loss = max(abs(x - y) / abs(y) for x, y in zip(r.train_loss_history[half:],
                                                   a.train_loss_history[half:]))
    leaf, noise = 0.0, 0.0
    for k, pa, pr, p0 in zip(keys, _param_copy(a), _param_copy(r), at_ck):
        d = (pr.double() - pa.double())
        if k in cancelled:
            noise = max(noise, float(d.abs().max()))
        else:
            leaf = max(leaf, float(d.norm() / (pa.double() - p0.double()).norm()))
    return {"loss": loss, "leaf": leaf, "cancelled_abs": noise}


def resume_misses(gap, dname):
    """The limits a resume's gap misses (RESUME_LIMITS, RESUME_CANCELLED_ABS)."""
    lim = RESUME_LIMITS[dname]
    out = [k for k in ("loss", "leaf") if not gap[k] <= lim[k]]
    return out + ([] if gap["cancelled_abs"] <= RESUME_CANCELLED_ABS else ["cancelled_abs"])


def deterministic_resume(torch, opt, make, dname):
    """Phase 14's resume under torch.use_deterministic_algorithms(True)
    (cuBLAS workspace ":4096:8", set at the script's start): a fresh
    uninterrupted run of `make()` and a trainer restored from its
    iteration-5 checkpoint end bit for bit equal, every loss and every
    parameter. The mode is put back to the default after."""
    half = TRAIN_ITERS // 2
    torch.use_deterministic_algorithms(True)
    try:
        a = make()
        a.train(half, log_fn=lambda *x: None)
        r = make()
        r.restore_train_state(opt.checkpoint_name + "_state")
        for tr in (a, r):
            tr.train(TRAIN_ITERS, log_fn=lambda *x: None)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = [bool(torch.equal(x, y)) for x, y in zip(_param_copy(a), _param_copy(r))]
    log(f"training {dname} resume under deterministic algorithms: iterations "
        f"{half + 1}-{TRAIN_ITERS} losses equal {a.train_loss_history == r.train_loss_history}, "
        f"{sum(same)} of {len(same)} parameter leaves bit-identical")
    if not all(same) or a.train_loss_history != r.train_loss_history:
        raise AssertionError(f"training {dname}: the deterministic resume is not "
                             f"bit-identical ({same.count(False)} leaves differ)")


def run_training(torch, workdir, smi):
    """Phase 14: the style trainer at full width (canonical architecture,
    256x256, batch 4, a full-width VGG-16 from a numpy seed, the bundled
    candy style at 384 px, shift:1,zoom_out:1,vr:1, 1 step then 2 from
    iteration 5, 10 iterations, validation and a checkpoint every 5),
    float32 then bfloat16, on seeded uint8 images through ArraySource;
    then fresh trainers restored from iteration 5 continue to 10 beside
    the uninterrupted run: the true resume within RESUME_LIMITS, each
    planted fault of RESUME_FAULTS outside them. Where h5py is installed, two more float32
    iterations read an HDF5 written by the port's make_image_dataset.
    Returns {dtype: figures}."""
    import math

    import numpy as np
    from fast_artistic_videos_tpu_torch.core.config import TrainOptions
    from fast_artistic_videos_tpu_torch.models import registry
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer
    from fast_artistic_videos_tpu_torch.video.evaluation import load_vgg_params

    kernels = _kernels()
    vgg_path = os.path.join(workdir, "vgg16.npz")
    if not os.path.exists(vgg_path):
        vgg_npz(EVAL_VGG_SEED, vgg_path)
    vgg_params = load_vgg_params(vgg_path, "cuda")
    images = seeded_images(TRAIN_IMAGE_SEED, TRAIN_IMAGES, TRAIN_SIZE)
    half = TRAIN_ITERS // 2
    cancelled = None
    out = {}
    for dname in ("float32", "bfloat16"):
        opt = TrainOptions(
            train_img_size=f"{TRAIN_SIZE}:{TRAIN_SIZE}", batch_size=TRAIN_BATCH,
            style_image=registry.style_fixture("candy"), style_image_size=384,
            data_mix="shift:1,zoom_out:1,vr:1", num_frame_steps=f"0:1,{half - 1}:2",
            num_iterations=TRAIN_ITERS, checkpoint_every=half, num_val_batches=1,
            print_every=1, history_every=1, images_every=0, dtype=dname,
            checkpoint_name=os.path.join(workdir, f"train_{dname}", "ck"))

        def trainer():
            tr = Trainer(opt, vgg_params=vgg_params, device="cuda")
            tr.image_source = ArraySource(images, TRAIN_BATCH)
            return tr
        a = trainer()
        cancelled = cancelled_biases(a.spec)
        init = _param_copy(a)
        probe = TrainProbe(torch, a, kernels, dname)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        t0 = time.monotonic()
        a.train(half, log_fn=log)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        # the true resume and the planted faults, each restored from the
        # iteration-5 checkpoint before the uninterrupted run overwrites it
        restored = {}
        for fault in RESUME_FAULTS:
            r = trainer()
            r.restore_train_state(opt.checkpoint_name + "_state")
            _plant(fault, r, opt)
            restored[fault] = (r, _param_copy(r))
        t0 = time.monotonic()
        a.train(TRAIN_ITERS, log_fn=log)
        torch.cuda.synchronize()
        secs += time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        k4 = kernels["conv3x3"]
        launches = {name: k.launches for name, k in kernels.items()}
        want = probe.expected_k4()
        log(f"training {dname}: batches {probe.batches}; launches {launches}, K4 by entry "
            f"{k4.routes}; K4 expected {want} (10 per forward-only pass: "
            f"{probe.passes[False]} passes); {probe.passes[True]} gradient passes and "
            f"backwards launched no kernel")
        if (k4.launches != want or k4.routes != {ENTRIES[dname]["conv3x3"]: want}
                or any(v for name, v in launches.items() if name != "conv3x3")
                or probe.passes[False] * 10 != want):
            raise AssertionError(f"training {dname}: launches {launches} {k4.routes} != "
                                 f"K4 {want}")
        losses_a = a.train_loss_history
        if len(losses_a) != TRAIN_ITERS or not all(math.isfinite(v) for v in
                                                   losses_a + a.val_loss_history):
            raise AssertionError(f"training {dname}: losses {losses_a} {a.val_loss_history}")
        moved = [bool((t != t0_).any()) for t, t0_ in zip(_param_copy(a), init)]
        if not all(moved):
            raise AssertionError(f"training {dname}: {moved.count(False)} parameter leaves "
                                 f"did not move")
        # the restored runs against the uninterrupted one: the true resume
        # within the limits, each planted fault outside them
        gaps = {}
        for fault, (r, at_ck) in restored.items():
            r.train(TRAIN_ITERS, log_fn=lambda *x: None)
            gap = resume_gap(a, r, at_ck, half, cancelled)
            misses = resume_misses(gap, dname)
            log(f"training {dname} resume ({fault or 'no fault'}): losses of iterations "
                f"{half + 1}-{TRAIN_ITERS} restored {r.train_loss_history[half:]} vs "
                f"uninterrupted {losses_a[half:]}; {gap}; limits {RESUME_LIMITS[dname]}, "
                f"cancelled biases {RESUME_CANCELLED_ABS:g} abs; missed {misses}")
            if r.iteration != TRAIN_ITERS or bool(misses) != bool(fault):
                raise AssertionError(f"training {dname} resume ({fault or 'no fault'}): "
                                     f"{gap}, missed {misses}")
            gaps[fault] = gap
        del restored
        deterministic_resume(torch, opt, trainer, dname)
        t = probe.times(half)
        bound_ms, sty_gflop, vgg_gflop = train_bound(torch, a, probe, half, dname)
        t.update(bound_ms=bound_ms, stylizer_gflop=sty_gflop, loss_network_gflop=vgg_gflop,
                 images_per_s=TRAIN_BATCH / t["iteration"] * 1e3, peak_gib=peak / 2 ** 30,
                 k4_launches=launches["conv3x3"], seconds=secs, resume=gaps)
        t.update(train_profile(torch, a, 2))
        t["busy"] = t["device_ms"] / t["iteration"]
        log(f"training {TRAIN_SIZE}^2 x{TRAIN_BATCH} {dname}: iteration {t['iteration']:.3f} ms "
            f"(median of iterations {half + 1}-{TRAIN_ITERS}, CUDA events, its batch and step): "
            f"batch {t['batch']:.3f}, forward-only passes {t['forward_only']:.3f}, gradient "
            f"pass (forward and backward) {t['gradient_pass']:.3f}, optimizer "
            f"{t['optimizer']:.3f} ms; kernel time {t['device_ms']:.3f} ms an iteration over 2 "
            f"more (torch.profiler), busy share {t['busy']:.3f}; top kernels "
            f"{t['top_kernels']}; "
            f"{t['images_per_s']:.2f} images/s; peak {t['peak_gib']:.3f} GiB "
            f"(max_memory_allocated); bound {bound_ms:.3f} ms by operations ({sty_gflop:.1f} "
            f"GFLOP stylizer in {dname}, {vgg_gflop:.1f} GFLOP loss network in float32); "
            f"{secs:.1f} s for the uninterrupted run; {smi}")
        out[dname] = t
        del a
        torch.cuda.empty_cache()
    out["h5py"] = _h5_training(torch, workdir, images, vgg_params)
    return out


def _h5_training(torch, workdir, images, vgg_params):
    """Two float32 iterations read from an HDF5 that the port's
    make_image_dataset writes from PNGs of the phase's images; None (and
    said) when h5py is not installed."""
    import math

    try:
        import h5py
    except ImportError:
        log("h5py: not installed on this host; the HDF5 sources and dataset tools were "
            "not run (the trainer read ArraySource)")
        return None
    from fast_artistic_videos_tpu_torch.cli import make_image_dataset
    from fast_artistic_videos_tpu_torch.core import io
    from fast_artistic_videos_tpu_torch.core.config import TrainOptions
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer

    d = os.path.join(workdir, "h5_images")
    os.makedirs(d, exist_ok=True)
    for i, img in enumerate(list(images["train"]) + list(images["val"])):
        io.save_image(os.path.join(d, f"img_{i:03d}.png"), img)
    h5 = os.path.join(workdir, "images.h5")
    make_image_dataset.main(["--input_dir", d, "--output_file", h5, "--height",
                             str(TRAIN_SIZE), "--width", str(TRAIN_SIZE),
                             "--val_fraction", "0.25"])
    opt = TrainOptions(h5_file=h5, train_img_size=f"{TRAIN_SIZE}:{TRAIN_SIZE}",
                       batch_size=TRAIN_BATCH, data_mix="shift:1,zoom_out:1",
                       num_iterations=2, checkpoint_every=10 ** 9, images_every=0,
                       print_every=1, history_every=1)
    tr = Trainer(opt, vgg_params=vgg_params, device="cuda")
    tr.train(log_fn=log)
    if not all(math.isfinite(v) for v in tr.train_loss_history):
        raise AssertionError(f"h5 training: losses {tr.train_loss_history}")
    log(f"h5py {h5py.__version__}: make_image_dataset wrote {h5}; 2 iterations from it, "
        f"losses {tr.train_loss_history}")
    return h5py.__version__


def check_train_fixture(torch, workdir):
    """Phase 15: the port's trainer in float32 on the card against the JAX
    trainer's fixture (tests/fixtures/torch_parity_train.npz,
    check_train_parity's tolerances)."""
    import numpy as np

    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_train.npz")) as z:
        fx = {k: z[k] for k in z.files}
    vgg = vgg_npz(int(fx["vgg_seed"]), os.path.join(workdir, "train_fixture_vgg16.npz"))
    return check_train_parity(fx, train_parity_run(torch, "cuda", vgg))


def run_flow_training(torch, k1, smi):
    """Phase 16: train_flow_synthetic from the bundled weights (256-px
    crops, batch 4, 20 iterations) on the card, whose gradient passes
    launch no kernel; then evaluate_heldout on the bundled weights at the
    fixture's size through K1 (3 feature warps per estimate), against the
    JAX function's results (tests/fixtures/torch_parity_flow_eval.npz):
    EPE rtol 1e-4, pass rates within 1e-3 (a pass rate counts pixels on
    either side of the check's threshold; 1e-3 is 37 of the 192^2)."""
    import math

    import numpy as np
    from fast_artistic_videos_tpu_torch.flow import estimator, train as flow_train

    kernels = _kernels()
    params = estimator.load_params("bundled", "cuda")
    step, steps = flow_train._step, []

    def timed(*a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        loss = step(*a)
        e.record()
        steps.append((s, e, loss))
        return loss
    _reset(kernels)
    flow_train._step = timed
    try:
        t0 = time.monotonic()
        trained = flow_train.train_flow_synthetic(
            iterations=FLOW_TRAIN_ITERS, batch_size=FLOW_TRAIN_BATCH, size=FLOW_TRAIN_SIZE,
            pool=FLOW_TRAIN_POOL, params=params, seed=3, log_every=10, log_fn=log,
            device="cuda")
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    finally:
        flow_train._step = step
    launches = {name: k.launches for name, k in kernels.items()}
    losses = [float(x) for _, _, x in steps]
    step_ms = _median([s.elapsed_time(e) for s, e, _ in steps[FLOW_TRAIN_ITERS // 2:]])
    if any(launches.values()) or len(losses) != FLOW_TRAIN_ITERS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"flow training: launches {launches}, losses {losses}")
    if not all(bool(torch.isfinite(t).all()) for v in trained.values() for t in v.values()):
        raise AssertionError("flow training: non-finite weights")
    log(f"flow training {FLOW_TRAIN_SIZE}^2 x{FLOW_TRAIN_BATCH}, {FLOW_TRAIN_ITERS} iterations "
        f"from the bundled weights: losses {[round(v, 4) for v in losses]}, launches "
        f"{launches} (the gradient passes take the banded warp's plain version); step "
        f"{step_ms:.3f} ms (CUDA events, median of the last {FLOW_TRAIN_ITERS // 2}: pair "
        f"synthesis, forward, backward, Adam); {secs:.1f} s with the image pool; {smi}")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_flow_eval.npz")) as z:
        fx = {k: z[k] for k in z.files}
    _reset(kernels)
    with k1.recording():
        res = flow_train.evaluate_heldout(params, size=int(fx["size"]),
                                          n_cases=int(fx["n_cases"]))
    k1.check(kernels["warp_banded"], "flow evaluation")
    want_k1 = len(fx["protocols"]) * int(fx["n_cases"]) * 2 * 3
    got = np.asarray([res[str(p)] for p in fx["protocols"]])
    want = fx["results"]
    epe_rel = np.abs(got[:, :2] - want[:, :2]) / want[:, :2]
    pass_abs = np.abs(got[:, 2:] - want[:, 2:])
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"flow evaluation {int(fx['size'])}^2 x{int(fx['n_cases'])} cases: {res}; launches "
        f"{launches} (K1 expected {want_k1}); against the JAX fixture EPE max rel "
        f"{epe_rel.max():.3g} (tol 1e-4), pass rates max abs {pass_abs.max():.3g} (tol 1e-3)")
    if (launches["warp_banded"] != want_k1 or epe_rel.max() > 1e-4
            or pass_abs.max() > 1e-3):
        raise AssertionError(f"flow evaluation: {got} vs {want}, launches {launches}")
    return {"step_ms": step_ms, "seconds": secs, "epe_rel": float(epe_rel.max()),
            "pass_abs": float(pass_abs.max())}


# ---------------------------------------------------------------------------
# phases 17-20: several cards
# ---------------------------------------------------------------------------

CARD_COUNTS = (1, 2, 4)
# cut to fit the script's time: 6 frames a stream (from 12; on four cards
# one thread per card runs at 4-7 frames/s in all), the thread-per-card
# form at the largest card count only, and 6 training iterations with the
# checkpoint at 3 (phase 14: 10 and 5)
SERVE_FRAMES, SERVE_SEED, SERVE_PROFILED = 6, 20261101, 2
DP_IMAGES, DP_SEED, DP_ITERS = 64, 20261102, 6
SPATIAL_SHARDS, SPATIAL_REPS, SIZE_4K = (2, 4), 5, (2160, 3840)
# a bfloat16 served stream against its solo run: two bfloat16 steps of an
# output in [0.5, 1] (see run_serving)
SERVE_BF16_MAX_ABS = 2 * 2.0 ** -8


def card_counts(torch):
    """(card counts of CARD_COUNTS this machine has, those it has not)."""
    n = torch.cuda.device_count()
    return [c for c in CARD_COUNTS if c <= n], [c for c in CARD_COUNTS if c > n]


def _sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _busy_by_card(torch, prof, wall_ms, cards):
    """Each card's busy share of a profiled window: the union of its
    kernels' device intervals (torch.profiler) over the window's wall
    time. Raises when the profiler recorded no kernel."""
    spans = {c: [] for c in range(cards)}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_index in spans:
            spans[ev.device_index].append((ev.time_range.start, ev.time_range.end))
    if not any(spans.values()):
        raise AssertionError("torch.profiler recorded no kernel on the cards")
    out = {}
    for c, iv in spans.items():
        busy, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        out[c] = busy / 1e3 / wall_ms
    return out


def _solo_streams(torch, spec, params, fparams, clips, devs, dname):
    """Each stream alone through an engine and a streaming provider of its
    own on devs[s % len(devs)]: {stream: [stylized frames]}."""
    from fast_artistic_videos_tpu_torch.flow import estimator
    from fast_artistic_videos_tpu_torch.flow.provider import StreamingFlowProvider
    from fast_artistic_videos_tpu_torch.models import stylizer
    from fast_artistic_videos_tpu_torch.video.engine import EngineConfig, StylizerEngine

    out = {}
    for s, clip in enumerate(clips):
        dev = devs[s % len(devs)]
        eng = StylizerEngine(lambda p, x: stylizer.apply(p, spec, x),
                             stylizer.to_device(params, dev), stride_multiple=spec.total_stride,
                             config=EngineConfig(dtype=dname), device=dev)
        prov = StreamingFlowProvider(flow_estimator=estimator.FlowEstimator(
            stylizer.to_device(fparams, dev),
            dtype=torch.bfloat16 if dname == "bfloat16" else torch.float32, device=dev),
            flow_scale=0.5)
        prev, out[s] = None, []
        for f in clip:
            frame = torch.from_numpy(f).to(dev)
            fc = prov(frame)
            prev = (eng.stylize_first(frame) if fc is None else
                    eng.stylize_next(frame, prev, fc[0], fc[1], prov.last_band))
            out[s].append(prev)
    return out


def run_serving(torch, counts, smi):
    """Phase 17: StreamPool (video/serving.py) of the demo model with the
    bundled flow estimator at flow scale 0.5 over the first c cards, for
    every c of `counts`: 2c streams of the 1080p pan from distinct seeds,
    SERVE_FRAMES frames each, float32 then bfloat16, driven by one host
    thread and, at the largest c, by one thread per card too. Checks: K1
    8 launches per stream-frame pair, K2 10 and K3 3 per stream-frame
    (phase 4's counts), no K4 or K5; every output on its stream's card;
    every stream against
    the same stream alone through an engine and a provider of its own on
    card s % (largest c): float32 within max abs 1e-3 of the [0, 1]
    range; bfloat16 within a mean-abs of 1e-3 a frame and a max abs of
    SERVE_BF16_MAX_ABS, printed beside the max abs between two solo runs
    of streams 0 and 1 (K2's and K3's statistics are float32 atomics, so
    two bfloat16 runs of one stream need not agree bit for bit: they
    differ by bfloat16 steps of the output, 2^-8 in [0.5, 1]; the pool
    and two solo runs differed by at most 2 steps in every run of this
    phase on H100 80GB HBM3 cards at 700 W). Times:
    streams x frames over the wall time (host clock, every card
    synchronized; no PNG), and each card's busy share in a profiled window
    of SERVE_PROFILED frames a stream. Returns {dtype: {c: figures}}."""
    import threading

    from fast_artistic_videos_tpu_torch.flow import estimator
    from fast_artistic_videos_tpu_torch.models import checkpoint
    from fast_artistic_videos_tpu_torch.video.serving import StreamPool

    kernels = _kernels()
    spec, params, _ = checkpoint.load_model("demo", "cuda:0")
    fparams = estimator.load_params("bundled", "cuda:0")
    frames, top = SERVE_FRAMES, max(counts)
    clips = [pan_frames(SERVE_SEED + s, frames, *SIZE_1080, PAN_1080) for s in range(2 * top)]
    want = {"warp_banded": 8 * (frames - 1), "res_chain_conv": 10 * frames,
            "front_conv": 3 * frames, "conv3x3": 0, "strip_warp": 0, "upsample_conv": 0}
    out = {}
    for dname in ("float32", "bfloat16"):
        top_devs = [torch.device("cuda", i) for i in range(top)]
        solo = _solo_streams(torch, spec, params, fparams, clips, top_devs, dname)
        spread = None
        if dname == "bfloat16":
            again = _solo_streams(torch, spec, params, fparams, clips[:2], top_devs, dname)
            spread = max((o - solo[s][t]).abs().max().item()
                         for s in again for t, o in enumerate(again[s]))
            del again
        out[dname] = {}
        for c in counts:
            n = 2 * c
            devs = [torch.device("cuda", i) for i in range(c)]
            pool = StreamPool(spec, params, flow_params=fparams, n_streams=n, devices=devs,
                              dtype=dname, flow_scale=0.5)

            def one_thread(count, rec):
                for t in range(count):
                    for s in range(n):
                        rec[s].append(pool.process(s, clips[s][t]))

            def per_card(count, rec):
                errors = []

                def body(card):
                    try:
                        for t in range(count):
                            for s in range(card, n, c):
                                rec[s].append(pool.process(s, clips[s][t]))
                    except BaseException as e:  # noqa: BLE001 - re-raised below
                        errors.append(e)
                threads = [threading.Thread(target=body, args=(k,)) for k in range(c)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                if errors:
                    raise errors[0]

            def restart():
                for s in range(n):
                    pool.reset(s)
            one_thread(2, {s: [] for s in range(n)})        # warm-up
            restart()
            _sync_all(torch)
            fig = {}
            forms = [("one thread", one_thread)] + (
                [("thread per card", per_card)] if c == top else [])
            for form, drive in forms:
                rec = {s: [] for s in range(n)}
                _reset(kernels)
                t0 = time.monotonic()
                drive(frames, rec)
                _sync_all(torch)
                wall = time.monotonic() - t0
                got = {name: k.launches for name, k in kernels.items()}
                if got != {k: v * n for k, v in want.items()}:
                    raise AssertionError(f"serving {dname} {c} cards ({form}): launches {got}, "
                                         f"want {n} x {want}")
                placed = all(o.device == devs[s % c] for s in rec for o in rec[s])
                diffs = [(o - solo[s][t].to(o.device)).abs()
                         for s in rec for t, o in enumerate(rec[s])]
                err = max(d.max().item() for d in diffs)
                mean = max(d.mean().item() for d in diffs)
                within = (err <= 1e-3 if dname == "float32" else
                          mean <= 1e-3 and err <= SERVE_BF16_MAX_ABS)
                limits = ("max 1e-3" if dname == "float32" else
                          f"mean 1e-3, max {SERVE_BF16_MAX_ABS:g}")
                if not placed or not within:
                    raise AssertionError(f"serving {dname} {c} cards ({form}): placed {placed}, "
                                         f"vs the solo streams max abs {err}, largest "
                                         f"mean-abs of a frame {mean}")
                del diffs
                del rec
                restart()
                _sync_all(torch)
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                            acc_events=True) as prof:
                    t1 = time.monotonic()
                    drive(SERVE_PROFILED, {s: [] for s in range(n)})
                    _sync_all(torch)
                    wall_p = (time.monotonic() - t1) * 1e3
                restart()
                busy = _busy_by_card(torch, prof, wall_p, c)
                fig[form] = {"fps": n * frames / wall, "stream_fps": frames / wall,
                             "busy": [round(busy[k], 3) for k in range(c)], "max_abs": err,
                             "mean_abs": mean, "solo_spread": spread}
                log(f"serving {dname} 1080p, {c} card(s), {n} streams x {frames} frames, {form}: "
                    f"{fig[form]['fps']:.3f} frames/s in all ({fig[form]['stream_fps']:.3f} a "
                    f"stream, no PNG, host clock), busy share by card {fig[form]['busy']} "
                    f"(torch.profiler, {SERVE_PROFILED} frames a stream); launches {got}; every "
                    f"output on its stream's card; vs the solo streams max abs {err:.3g}, "
                    f"largest mean-abs of a frame {mean:.3g} (limits: {limits})"
                    + ("" if spread is None else
                       f"; two solo runs of streams 0-1 differ by max abs {spread:.3g}")
                    + f"; {smi}")
            fig["launches"] = got
            out[dname][c] = fig
            del pool
        del solo
        torch.cuda.empty_cache()
    return out


def dp_batch(global_n):
    """The fixed global batch of phase 18's gradient check: a shift-source
    batch (one step) of the first global_n images of DP_SEED, drawn from
    numpy generators of DP_SEED; the same on every rank."""
    import numpy as np
    from fast_artistic_videos_tpu_torch.train import data as data_mod

    images = seeded_images(DP_SEED, global_n, TRAIN_SIZE)["train"].astype(np.float32) / 255.0
    return data_mod.shift_batch(images, 1, np.random.default_rng(DP_SEED))


def dp_grads(torch, trainer, global_n, rows=None):
    """The gradient of the trainer's loss (frame 1 by the model, one
    step) on this rank's rows of dp_batch(global_n) (or on `rows`, a
    slice, in a world of one), averaged over the ranks: (mean loss over
    the ranks, flat float32 numpy gradient). The trainer's gradients are
    cleared after."""
    from fast_artistic_videos_tpu_torch.core import device as device_mod
    from fast_artistic_videos_tpu_torch.parallel import mesh
    from fast_artistic_videos_tpu_torch.train.trainer import leaves

    imgs, flows, certs = (trainer._to_device(*(mesh.local_rows(part) if rows is None
                                               else [a[rows] for a in part]))
                          for part in dp_batch(global_n))
    with device_mod.float32_convs():
        loss, _ = trainer._loss_fn(trainer.params, imgs, flows, certs, 1, "self")
        trainer._backward(loss)
    mesh.all_reduce_grads(leaves(trainer.params))
    flat = torch.cat([t.grad.reshape(-1) for t in leaves(trainer.params)]).float().cpu().numpy()
    trainer.optimizer.zero_grad(set_to_none=True)
    return float(mesh.mean_over_ranks(loss.detach())), flat


def dp_train(workdir, device):
    """Phase 18's run of one rank (or of one process without a group):
    the phase-14 trainer with TRAIN_BATCH images a rank from its shard of
    DP_IMAGES seeded images, float32 then bfloat16. Under deterministic
    algorithms: the gradient on dp_batch(world x TRAIN_BATCH), DP_ITERS
    iterations with a checkpoint at half (CUDA-event times by TrainProbe),
    a trainer restored from that checkpoint run on beside it (bit-identical
    parameters and losses), and every rank's parameters against rank 0's.
    Returns {dtype: figures}; the gradient on rank 0 only."""
    import torch

    from fast_artistic_videos_tpu_torch.core.config import TrainOptions
    from fast_artistic_videos_tpu_torch.models import registry
    from fast_artistic_videos_tpu_torch.parallel import mesh
    from fast_artistic_videos_tpu_torch.train.data import shard_range
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer, leaves
    from fast_artistic_videos_tpu_torch.video.evaluation import load_vgg_params

    world, rank = mesh.world(), mesh.rank()
    dev = mesh.rank_device(device)
    torch.cuda.set_device(dev)
    kernels = _kernels()
    vgg_params = load_vgg_params(os.path.join(workdir, "vgg16.npz"), dev)
    lo, hi = shard_range(DP_IMAGES, world, rank)
    shard = {k: v[lo:hi] for k, v in seeded_images(DP_SEED, DP_IMAGES, TRAIN_SIZE).items()}
    half = DP_ITERS // 2
    out = {}
    for dname in ("float32", "bfloat16"):
        opt = TrainOptions(
            train_img_size=f"{TRAIN_SIZE}:{TRAIN_SIZE}", batch_size=TRAIN_BATCH * world,
            style_image=registry.style_fixture("candy"), style_image_size=384,
            data_mix="shift:1,zoom_out:1,vr:1", num_frame_steps=f"0:1,{half - 1}:2",
            num_iterations=DP_ITERS, checkpoint_every=half, num_val_batches=1,
            print_every=1, history_every=1, images_every=0, dtype=dname,
            num_data_devices=world,
            checkpoint_name=os.path.join(workdir, f"dp{world}_{dname}", "ck"))

        def make():
            tr = Trainer(opt, vgg_params=vgg_params, device=dev)
            tr.image_source = ArraySource(shard, TRAIN_BATCH)
            return tr
        torch.use_deterministic_algorithms(True)
        try:
            a = make()
            loss, grad = dp_grads(torch, a, TRAIN_BATCH * world)
            probe = TrainProbe(torch, a, kernels, dname)
            a.train(half, log_fn=lambda *x: None)
            r = make()
            r.restore_train_state(opt.checkpoint_name + "_state")
            a.train(DP_ITERS, log_fn=lambda *x: None)
            r.train(DP_ITERS, log_fn=lambda *x: None)
            torch.cuda.synchronize(dev)
        finally:
            torch.use_deterministic_algorithms(False)
        resumed = (a.train_loss_history == r.train_loss_history
                   and all(bool(torch.equal(x, y)) for x, y in zip(leaves(a.params),
                                                                    leaves(r.params))))
        flat = torch.cat([t.detach().reshape(-1) for t in leaves(a.params)])
        ref = flat.clone()
        if world > 1:
            torch.distributed.broadcast(ref, src=0)
        ranks_same = float(mesh.mean_over_ranks(torch.tensor(
            float(torch.equal(flat, ref)), device=dev))) == 1.0
        t = probe.times(half)
        out[dname] = {"loss": loss, "grad": grad if rank == 0 else None, "resumed": resumed,
                      "ranks_same": ranks_same, "losses": list(a.train_loss_history),
                      "iteration_ms": t["iteration"], "batch_ms": t["batch"],
                      "images_per_s": TRAIN_BATCH * world / t["iteration"] * 1e3,
                      "state": opt.checkpoint_name + "_state", "opt": opt}
        del a, r
        torch.cuda.empty_cache()
    return out


# phase 18's bar on a world's gradient against world 1's on the whole
# global batch at once, relative L2: about 15x and 10x the gaps of the
# first run (two gloo ranks on one H100 80GB HBM3, 700 W: 1.34e-4 float32,
# 2.0e-3 bfloat16)
GRAD_BATCH_LIMITS = {"float32": 2e-3, "bfloat16": 2e-2}


def _rel_l2(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def grad_parity(torch, trainer, got, world):
    """Phase 18's gradient check of a world's gradient `got` on
    dp_batch(world x TRAIN_BATCH), by `trainer` in this process (world 1):
    against the mean of the gradients of each rank's rows computed here
    one after the other (what the ranks compute, averaged as the
    all-reduce does; bit-identical at world 2, the reduction's order at
    world 4): relative L2 <= 1e-6; and against the gradient of the whole
    global batch at once (another batch shape, so other convolution
    algorithms and rounding, which the instance norm's one-pass variance
    amplifies: the JAX package's element-wise rtol 2e-4 does not hold for
    the elements near 0 here): relative L2 <= GRAD_BATCH_LIMITS. Returns
    the figures."""
    import numpy as np

    n = TRAIN_BATCH * world
    torch.use_deterministic_algorithms(True)
    try:
        _, full = dp_grads(torch, trainer, n)
        parts = [dp_grads(torch, trainer, n, slice(k * TRAIN_BATCH, (k + 1) * TRAIN_BATCH))[1]
                 for k in range(world)]
    finally:
        torch.use_deterministic_algorithms(False)
    mean = np.sum(parts, axis=0, dtype=np.float32) / np.float32(world)
    return {"vs_rows": _rel_l2(got, mean), "vs_rows_max_abs": float(np.abs(got - mean).max()),
            "vs_batch": _rel_l2(got, full), "vs_batch_max_abs": float(np.abs(got - full).max()),
            "grad_norm": float(np.linalg.norm(full))}


def run_data_parallel(torch, workdir, counts, smi):
    """Phase 18: data-parallel training at world 1 (this process) and
    world c for every c > 1 of `counts` (c NCCL processes, one a card); on
    a one-card machine, two gloo processes on card 0 check the contract
    only. Each world's gradient against world 1's on the same global batch
    (grad_parity), its same-world resume bit-identical, every rank's
    parameters equal; then world 1 restores each world's checkpoint (rank
    0's sidecar) and trains two more iterations. Images per second
    (TrainProbe's median iteration, CUDA events, deterministic algorithms)
    and the scaling efficiency against world 1. Returns {world: {dtype:
    figures}}."""
    import dataclasses
    import math

    from fast_artistic_videos_tpu_torch.parallel import mesh
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer
    from fast_artistic_videos_tpu_torch.video.evaluation import load_vgg_params

    vgg_path = os.path.join(workdir, "vgg16.npz")
    if not os.path.exists(vgg_path):
        vgg_npz(EVAL_VGG_SEED, vgg_path)
    runs = {1: dp_train(workdir, "cuda:0")}
    worlds = [(c, "nccl", "cuda") for c in counts if c > 1] or [(2, "gloo", "cuda:0")]
    backends = {1: "none"}
    for world, backend, device in worlds:
        # each rank samples its batch with torch on the host: the host's
        # cores are split between the ranks (torchrun's default is one
        # thread a rank), or the ranks' thread pools contend for them
        runs[world] = mesh.spawn_ranks(dp_train, world, workdir, device, backend=backend,
                                       timeout=900,
                                       threads=max(1, (os.cpu_count() or 1) // world))[0]
        backends[world] = backend
    vgg_params = load_vgg_params(vgg_path, "cuda:0")
    images = seeded_images(DP_SEED, DP_IMAGES, TRAIN_SIZE)
    out = {}
    for world, res in runs.items():
        out[world] = {}
        for dname in ("float32", "bfloat16"):
            r = res[dname]
            par, restored = None, None
            if world > 1:
                # world 1 on the same global batch, then on this world's checkpoint
                opt1 = dataclasses.replace(r["opt"], num_data_devices=1,
                                           checkpoint_name=r["opt"].checkpoint_name + "_w1")
                tr = Trainer(opt1, vgg_params=vgg_params, device="cuda:0")
                par = grad_parity(torch, tr, r["grad"], world)
                tr.image_source = ArraySource(images, TRAIN_BATCH * world)
                tr.restore_train_state(r["state"])
                tr.train(DP_ITERS + 2, log_fn=lambda *x: None)
                restored = tr.train_loss_history[DP_ITERS:]
                if tr.iteration != DP_ITERS + 2 or not all(math.isfinite(v)
                                                                for v in restored):
                    raise AssertionError(f"world {world} {dname}: the restore onto world 1 "
                                         f"did not train on: {restored}")
                del tr
            eff = r["images_per_s"] / (world * runs[1][dname]["images_per_s"])
            fig = {k: r[k] for k in ("loss", "resumed", "ranks_same", "iteration_ms",
                                     "batch_ms", "images_per_s")}
            fig.update(grad=par, efficiency=eff, backend=backends[world],
                       restored_world_1=restored)
            contract = backends[world] == "gloo"
            grad_line = "" if par is None else (
                f"; gradient on the global batch of {TRAIN_BATCH * world} vs world 1 on each "
                f"rank's rows, averaged: rel L2 {par['vs_rows']:.3g} (max abs "
                f"{par['vs_rows_max_abs']:.3g}; limit 1e-6), vs world 1 on the whole batch at "
                f"once: rel L2 {par['vs_batch']:.3g} (limit {GRAD_BATCH_LIMITS[dname]:g}; max "
                f"abs {par['vs_batch_max_abs']:.3g}, gradient norm {par['grad_norm']:.4g})")
            log(f"data-parallel {dname} world {world} ({backends[world]}"
                f"{'; two ranks on card 0: the contract only, no scaling' if contract else ''}): "
                f"loss {r['loss']:.6g}{grad_line}; same-world resume bit-identical "
                f"{r['resumed']}; ranks' parameters equal {r['ranks_same']}; iteration "
                f"{r['iteration_ms']:.3f} ms (its batch on the host {r['batch_ms']:.3f} ms, "
                f"serial in each rank), {r['images_per_s']:.2f} images/s"
                + ("" if contract else f", scaling efficiency {eff:.3f}")
                + ("" if restored is None else f"; restored onto world 1, losses of "
                   f"iterations {DP_ITERS + 1}-{DP_ITERS + 2}: {restored}") + f"; {smi}")
            ok = par is None or (par["vs_rows"] <= 1e-6
                                 and par["vs_batch"] <= GRAD_BATCH_LIMITS[dname])
            if not (ok and r["resumed"] and r["ranks_same"]):
                raise AssertionError(f"data-parallel {dname} world {world}: {fig}")
            out[world][dname] = fig
        torch.cuda.empty_cache()
    return out


def run_spatial(torch, counts, smi):
    """Phase 19: SpatialStylizer (parallel/spatial.py) of the demo model on
    a 1080p frame (float32, seeded VGG-space input), split over k of
    SPATIAL_SHARDS cards (on a one-card machine: 2 shards on card 0,
    stated, no speed-up claimed), against the unsharded plain forward on
    card 0: max abs <= 2e-3 (the JAX package's bar for its sharded
    forward). Latency: host clock with every card synchronized, median of
    SPATIAL_REPS after one warm-up, beside the unsharded plain and kernel
    forwards on one card. Then one 4K (2160x3840) forward on card 0, plain
    and kernel path, with its peak memory. Returns the figures."""
    from fast_artistic_videos_tpu_torch.models import checkpoint, stylizer
    from fast_artistic_videos_tpu_torch.parallel.spatial import SpatialStylizer

    cards = torch.cuda.device_count()
    spec, params, _ = checkpoint.load_model("demo", "cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(19)

    def frame(h, w):
        return torch.randn(1, h, w, 7, device="cuda:0", generator=gen) * 60

    def latency(fn):
        fn()
        ms = []
        for _ in range(SPATIAL_REPS):
            _sync_all(torch)
            t0 = time.monotonic()
            out = fn()
            _sync_all(torch)
            ms.append((time.monotonic() - t0) * 1e3)
        return _median(ms), out

    x = frame(*SIZE_1080)
    with torch.no_grad():
        plain_ms, ref = latency(lambda: stylizer.apply(params, spec, x, fused=False))
        kernel_ms, _ = latency(lambda: stylizer.apply(params, spec, x))
        out = {"plain_ms": plain_ms, "kernel_ms": kernel_ms, "shards": {}}
        for k in SPATIAL_SHARDS:
            if k <= cards:
                devs, note = [torch.device("cuda", i) for i in range(k)], f"{k} cards"
            elif k == 2:
                devs, note = [torch.device("cuda", 0)] * 2, "2 shards on card 0"
            else:
                log(f"spatial 1080p, {k} shards: not run ({cards} card{'s' * (cards > 1)})")
                continue
            sp = SpatialStylizer(spec, params, devices=devs)
            ms, got = latency(lambda: sp(x))
            err = (got - ref).abs().max().item()
            log(f"spatial 1080p float32, {note}: {ms:.3f} ms a frame (host clock, median of "
                f"{SPATIAL_REPS}) vs unsharded plain {plain_ms:.3f} ms and kernel path "
                f"{kernel_ms:.3f} ms on one card; max abs vs the unsharded plain forward "
                f"{err:.3g} (limit 2e-3); {smi}")
            if not err <= 2e-3:
                raise AssertionError(f"spatial {note}: max abs {err} > 2e-3")
            out["shards"][note] = {"ms": ms, "max_abs": err}
            del sp, got
        del ref
        torch.cuda.empty_cache()
        x4 = frame(*SIZE_4K)
        torch.cuda.reset_peak_memory_stats(0)
        plain4, y4 = latency(lambda: stylizer.apply(params, spec, x4, fused=False))
        peak_plain = torch.cuda.max_memory_allocated(0) / 2 ** 30
        del y4
        torch.cuda.reset_peak_memory_stats(0)
        kernel4, y4 = latency(lambda: stylizer.apply(params, spec, x4))
        peak_kernel = torch.cuda.max_memory_allocated(0) / 2 ** 30
    if tuple(y4.shape) != (1, *SIZE_4K, 3) or not bool(torch.isfinite(y4).all()):
        raise AssertionError(f"4K forward: {tuple(y4.shape)}, finite "
                             f"{bool(torch.isfinite(y4).all())}")
    out.update(plain_4k_ms=plain4, kernel_4k_ms=kernel4, peak_4k_gib=(peak_plain, peak_kernel))
    log(f"4K ({SIZE_4K[0]}x{SIZE_4K[1]}) float32 forward on one card: plain {plain4:.3f} ms "
        f"(peak {peak_plain:.3f} GiB), kernel path {kernel4:.3f} ms (peak {peak_kernel:.3f} "
        f"GiB; max_memory_allocated, host clock, median of {SPATIAL_REPS}); {smi}")
    return out


def run_dryrun(torch, smi):
    """Phase 20: parallel/dryrun.py dryrun_multichip on every card."""
    from fast_artistic_videos_tpu_torch.parallel.dryrun import dryrun_multichip

    n = torch.cuda.device_count()
    t0 = time.monotonic()
    res = dryrun_multichip(n, device="cuda", timeout=600)
    log(f"dryrun_multichip({n}) on {n} card(s): {time.monotonic() - t0:.1f} s; {smi}")
    return res


def run_cards(torch, workdir, smi):
    """Phases 17-20 at every card count this machine has; the others are
    printed as not run. Returns (figures, seconds)."""
    counts, missing = card_counts(torch)
    for c in missing:
        log(f"phases 17-19 at {c} cards: not run ({torch.cuda.device_count()} cards)")
    t0 = time.monotonic()
    out = {"counts": counts, "not_run": missing, "seconds": {}}
    for key, run in (("serving", lambda: run_serving(torch, counts, smi)),
                     ("data_parallel", lambda: run_data_parallel(torch, workdir, counts, smi)),
                     ("spatial", lambda: run_spatial(torch, counts, smi)),
                     ("dryrun", lambda: run_dryrun(torch, smi))):
        t1 = time.monotonic()
        out[key] = run()
        out["seconds"][key] = round(time.monotonic() - t1, 1)
    return out, time.monotonic() - t0


def _summary_cards(cards, secs, smi):
    """The lines that sum phases 17-20 up."""
    for dname, by_c in cards["serving"].items():
        for c, fig in by_c.items():
            log(f"serving {dname} {c} card(s) x {2 * c} streams: "
                + "; ".join(f"{form} {fig[form]['fps']:.3f} frames/s, busy {fig[form]['busy']}"
                            for form in ("one thread", "thread per card") if form in fig))
    for world, by_d in cards["data_parallel"].items():
        log(f"data-parallel world {world}: " + "; ".join(
            f"{d} {f['images_per_s']:.2f} images/s (efficiency {f['efficiency']:.3f}, "
            f"{f['backend']})" for d, f in by_d.items()))
    sp = cards["spatial"]
    log(f"spatial 1080p float32: unsharded plain {sp['plain_ms']:.3f} ms, kernel path "
        f"{sp['kernel_ms']:.3f} ms; " + "; ".join(f"{k} {v['ms']:.3f} ms (max abs "
                                                 f"{v['max_abs']:.3g})"
                                                 for k, v in sp["shards"].items())
        + f"; 4K plain {sp['plain_4k_ms']:.3f} ms, kernel path {sp['kernel_4k_ms']:.3f} ms")
    log(f"{cards['dryrun']['line']}; card counts run {cards['counts']}, not run "
        f"{cards['not_run']}; phases 17-20 took {secs:.1f} s (by phase {cards['seconds']}); "
        f"{smi}")


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
    # phase 14's deterministic resume: cuBLAS reads its workspace setting
    # when it creates a handle, before the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if sys.argv[1:] == ["--cards-only"]:
        # phases 17-20 alone (a call on four cards need not repeat 3-16);
        # no result line: the run is not the whole drive
        with tempfile.TemporaryDirectory() as work:
            cards, t_cards = run_cards(torch, work, smi)
        _summary_cards(cards, t_cards, smi)
        log(smi)
        return 0
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
        # 14. the style trainer; 15. the trainer against the JAX trainer's
        # fixture; 16. flow training, and the flow evaluation through K1
        t_train = time.monotonic()
        k4 = ConvShapes()
        with k4.recording():
            training = run_training(torch, work, smi)
            parity = check_train_fixture(torch, work)
        flow_tr = run_flow_training(torch, k1, smi)
        t_train = time.monotonic() - t_train
        # 17. multi-stream serving; 18. data-parallel training; 19. spatial
        # sharding and 4K on one card; 20. the multi-card dry run
        cards, t_cards = run_cards(torch, work, smi)
    # 3, continued: K1 at every shape phases 4, 6, 9, 11, 13 and 16 launched,
    # K4 at every shape phases 14 and 15 launched
    check_recorded_warps(torch, res, k1)
    check_recorded_convs(torch, res, k4)
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
        if name == "conv3x3":
            # K4's launches on the training path (phase 14's uninterrupted
            # runs: 10 per forward-only pass at batch 4), and phase 3's
            # cases at every shape phases 14 and 15 launched it at, on the
            # inputs of the first launch there
            row["training_launches"] = {d: training[d]["k4_launches"]
                                        for d in ("float32", "bfloat16")}
            row["training_cases"] = [
                {"shape": c["shape"], "dtype": _dname(torch, c["dtype"]), "entry": c["entry"],
                 "where": c["where"], "rel_l2": c["rel_l2"], "max_abs_err": c["err"],
                 "device_by": c["device_by"], **figures(c)} for c in cases if c["where"] != "block conv"]
        if name in ("warp_banded", "res_chain_conv", "front_conv"):
            # phase 17's launches at the largest card count (2 streams a card)
            top = max(cards["counts"])
            row["serving_launches"] = {d: cards["serving"][d][top]["launches"][name]
                                       for d in ("float32", "bfloat16")}
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
    # K6: float32 only (bfloat16 keeps the layer-by-layer path); its launches
    # in the main path's float32 run (none: the demo model's upsamples are
    # learned) and in the canonical net's stylizer, a call at 1080p and on a
    # face; its cases at the canonical tail's four shapes
    k6, cases = kernels["upsample_conv"], res["upsample_conv"]
    rows.append({"name": "upsample_conv", "route": "cuda", "source": k6.source,
                 "replaces": k6.replaces, "entry": cases[0]["entry"],
                 "launches": counted["float32"]["upsample_conv"],
                 "canonical": res["canonical_tail"],
                 "max_abs_err": max(c["err"] for c in cases), **figures(cases[0]),
                 "cases": [{"shape": c["shape"], "max_abs_err": c["err"],
                            "unfolded_bound_ms": c["unfolded_bound_ms"], **figures(c)}
                           for c in cases],
                 "bfloat16": {"route": "layer by layer (cuDNN)"}})
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
    for d in ("float32", "bfloat16"):
        t = training[d]
        log(f"training {TRAIN_SIZE}^2 x{TRAIN_BATCH} {d}: iteration {t['iteration']:.3f} ms "
            f"(batch {t['batch']:.3f}, forward-only {t['forward_only']:.3f}, gradient pass "
            f"{t['gradient_pass']:.3f}, optimizer {t['optimizer']:.3f}; busy share "
            f"{t['busy']:.3f}), {t['images_per_s']:.2f} images/s, peak "
            f"{t['peak_gib']:.3f} GiB, bound {t['bound_ms']:.3f} ms, K4 {t['k4_launches']} "
            f"launches")
    log(f"trainer fixture parity {parity}; h5py {training['h5py']}; flow training step "
        f"{flow_tr['step_ms']:.3f} ms, flow evaluation fixture EPE rel {flow_tr['epe_rel']:.3g}, "
        f"pass abs {flow_tr['pass_abs']:.3g}; phases 14-16 took {t_train:.1f} s; {smi}")
    _summary_cards(cards, t_cards, smi)
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
