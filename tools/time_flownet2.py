"""FlowNet 2.0 on the card at the benchmark cell's shape (a 1080p clip, flow
at scale 0.5: 576x960 padded, FlowNetC's maps 72x120x256), with weights
drawn from a seed as the cell draws them:

* K7 (``ops.correlation_kernel``) at one image and at the two directions
  of a pair in one launch: CUDA-event time (median of 20 after a warm-up),
  its least time by operations and bytes, the share, and the plain
  version's time; the kernel against the plain version;
* one ``refine_pair`` of the estimator: the device time of each network
  (CUDA events around FlowNetC, the two FlowNetS, FlowNetSD and the fusion
  net) and of the whole call;
* the seeded flow on the cell's (6, 3)-px pan through the streaming
  provider: |flow| percentiles in full-resolution pixels, the engine's
  warp band (K1's) and the certainty's mean, frame by frame.

    python3 tools/time_flownet2.py LABEL [SEED]

Prints one JSON line a section, each with the card's name and power limit.
Uses only the port's public entries and ``portbench/``, so it also runs in
an older checkout that has them.
"""

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


def _card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = "unknown"
    return out


def _events_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_k7(label, card):
    from fast_artistic_videos_tpu_torch.ops import correlation_kernel as ck

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for n, shift in ((1, 0), (2, 1)):
        maps = torch.from_numpy(rng.standard_normal((n, 256, 72, 120)).astype(np.float32)).to(dev)
        buf = torch.empty((n, 473, 72, 120), device=dev)
        out = buf[:, 32:]
        ms = _events_ms(lambda: ck.correlation(maps, maps, out=out, b_shift=shift))
        plain_ms = _events_ms(lambda: ck.correlation_plain(maps, maps, b_shift=shift), reps=3)
        err = (ck.correlation(maps, maps, out=out, b_shift=shift)
               - ck.correlation_plain(maps, maps, b_shift=shift)).abs().max().item()
        flops = 2 * 441 * 256 * 72 * 120 * n
        nbytes = 4 * (n * 256 * 72 * 120 + n * 441 * 72 * 120)
        bound_ms = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S) * 1e3
        print(json.dumps({"label": label, "section": "k7", "card": card, "images": n,
                          "b_shift": shift, "kernel_ms": ms, "bound_ms": bound_ms,
                          "bound_by": "operations" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES_S
                          else "bytes", "roofline_pct": 100 * bound_ms / ms,
                          "plain_ms": plain_ms, "max_abs_err": err}), flush=True)


def time_stages(label, card, seed):
    from fast_artistic_videos_tpu_torch.flow import flownet2
    from portbench.reference import flow_flownet2 as ref

    dev = torch.device("cuda")
    est = flownet2.FlowNet2Estimator(ref.draw(seed, dev), device=dev)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)).to(dev)
    fa, fb = est.prep(frames[0], 0.5), est.prep(frames[1], 0.5)
    stages = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            stages.setdefault(name, []).append((a, b))
            return out
        return call

    est._flownetc = timed("flownetc", est._flownetc)
    est._flownetsd = timed("flownets_d", est._flownetsd)
    est._fusion = timed("fusion", est._fusion)
    est._flownets = timed("flownets", est._flownets)
    whole = _events_ms(lambda: est.refine_pair(fa, fb, (1080, 1920), 0.5, with_lowres=True))
    torch.cuda.synchronize()
    # the last 20 calls (40 of the FlowNetS, run twice a pair): one network each
    per = {k: statistics.median([a.elapsed_time(b) for a, b in v[-20 * len(v) // 21:]])
           for k, v in stages.items()}
    print(json.dumps({"label": label, "section": "stages", "card": card,
                      "refine_pair_ms": whole, "stage_ms": per,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)


def flow_stats(label, card, seed, frames_n=6):
    from fast_artistic_videos_tpu_torch.flow import flownet2
    from fast_artistic_videos_tpu_torch.flow.provider import StreamingFlowProvider
    from portbench.harness import frames
    from portbench.reference import flow_flownet2 as ref

    dev = torch.device("cuda")
    est = flownet2.FlowNet2Estimator(ref.draw(seed, dev), device=dev)
    prov = StreamingFlowProvider(flow_estimator=est, flow_scale=0.5, erode_window=7)
    pan = frames.Source(seed, 1920).pans(1, 1080, 1920, (6, 3))[0]
    rows = []
    for t in range(frames_n):
        got = prov(torch.from_numpy(np.ascontiguousarray(pan.frame(t))).to(dev))
        if got is None:
            continue
        flow, cert = got
        mag = flow.norm(dim=-1).flatten().cpu().numpy()
        rows.append({"frame": t, "flow_px_p": [float(np.percentile(mag, q))
                                               for q in (5, 50, 95, 99.9)],
                     "flow_mean_dx_dy": [float(v) for v in flow.mean(dim=(0, 1)).tolist()],
                     "band": prov.last_band, "certainty_mean": float(cert.float().mean())})
    print(json.dumps({"label": label, "section": "flow", "card": card, "seed": seed,
                      "pan": [6, 3], "frames": rows}), flush=True)


def main():
    label = sys.argv[1] if len(sys.argv) > 1 else "run"
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 2147483901
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card()
    time_k7(label, card)
    time_stages(label, card, seed)
    flow_stats(label, card, seed)


if __name__ == "__main__":
    main()
