"""Tracing and timing — counterpart of ``fast_artistic_videos_tpu/utils/profiling.py``.

  * StageTimer — running per-stage wall-clock stats for the host loop
    (load / flow / stylize / save), printed as a table (a copy of the JAX
    package's);
  * device_trace — context manager around ``torch.profiler`` writing a
    Chrome trace into a directory. Unlike the JAX package's, a profiler
    that fails to start raises; only a falsy ``log_dir`` makes it a no-op;
  * device_sync — completion barrier for a tensor's card plus a scalar
    readback (the JAX package's ``float(jnp.sum(x))``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def device_sync(x) -> float:
    """Wait for everything producing `x` on its card; returns a checksum."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.float().sum())


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.totals[name] += time.monotonic() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':<16} {'total s':>9} {'count':>7} {'ms/call':>9}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<16} {t:9.2f} {n:7d} {1000*t/max(n,1):9.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace (host and, where a card is present, CUDA
    activity) of the block, written to ``log_dir/trace.json`` (Chrome
    trace format, viewable in Perfetto). No-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
