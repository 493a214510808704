"""The readings that the limits of ``correct`` are set from: one cell run
on several seeds in one process, by the program as the configuration
states it or by its bfloat16 path (the control), each seed's numbers
compared with the reference printed as one JSON line.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 8 [--dtype bfloat16]

The benchmark's own runs do not run this. A seed's window is short and at
the cell's own load; the check is the run's own.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import guard, spec  # noqa: E402
from portbench.harness.main import HOST_THREADS, run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--dtype", default=None, help="the control: bfloat16")
    args = p.parse_args(argv)
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("calibrate: not enough cards", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.set_num_threads(HOST_THREADS)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t = time.monotonic()
        result, faults = run_cell(cell, seed, args.seconds, False, devices, t,
                                  dtype=args.dtype)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or cell.config["dtype"],
                          "numbers": {k: v["value"] for k, v in result["checks"].items()},
                          "faults": faults[:5], "frames_per_s":
                          result["metrics"].get("frames_per_s", {}).get("value"),
                          "seconds": time.monotonic() - t}), flush=True)
    bad = guard.loaded()
    if bad:
        print(f"calibrate: loaded {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
