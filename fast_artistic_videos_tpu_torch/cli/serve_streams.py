"""CLI: stylize SEVERAL frame sequences concurrently, one stream per card —
counterpart of ``fast_artistic_videos_tpu/cli/serve_streams.py``.

The serving entry point for multi-clip throughput (``video/serving.py``
``StreamPool``): each clip's temporal recurrence is pinned to one card,
round-robin; different clips' launches overlap. On one card the streams
interleave.

Example (two clips over every card):

  python -m fast_artistic_videos_tpu_torch.cli.serve_streams \\
      --model_vid demo --flow_model bundled \\
      --inputs clipA/frame_%05d.ppm,clipB/frame_%05d.ppm \\
      --output_dir out/

Outputs land in out/stream<i>-<frame>.png. ``--device cuda`` (the default)
spreads the streams over every card, ``cuda:N`` keeps them on card N, and
``cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os

from ..core import io
from ..flow import estimator as flow_estimator
from ..models import checkpoint
from ..utils import pipeline


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_vid", required=True)
    p.add_argument("--flow_model", required=True,
                   help="flow weights (.npz) or 'bundled'")
    p.add_argument("--inputs", required=True,
                   help="comma-separated frame patterns, one per stream")
    p.add_argument("--output_dir", default="out")
    p.add_argument("--num_frames", type=int, default=9999)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--flow_scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: every card), cuda:N or cpu")
    args = p.parse_args(argv)

    from ..core.device import resolve_all
    from ..video.serving import StreamPool

    patterns = [s for s in args.inputs.split(",") if s]
    devices = resolve_all(args.device)
    spec, params, _ = checkpoint.load_model(args.model_vid, devices[0])
    pool = StreamPool(spec, params,
                      flow_params=flow_estimator.load_params(args.flow_model, devices[0]),
                      n_streams=len(patterns), devices=devices, dtype=args.dtype,
                      flow_scale=args.flow_scale)

    os.makedirs(args.output_dir, exist_ok=True)
    writer = pipeline.AsyncWriter()
    live = {s: True for s in range(len(patterns))}
    n_out = 0
    try:
        t = 1
        while any(live.values()) and t <= args.num_frames:
            for s, pat in enumerate(patterns):
                if not live[s]:
                    continue
                path = pat % t
                if not os.path.exists(path):
                    live[s] = False
                    continue
                out = pool.process(s, io.load_image(path))
                dst = os.path.join(args.output_dir, f"stream{s}-{t:05d}.png")
                writer.put(lambda d=dst, o=out: io.save_image(d, o.cpu().numpy()))
                n_out += 1
            t += 1
    finally:
        writer.close()
    print(f"{n_out} frames across {len(patterns)} streams -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
