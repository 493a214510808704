"""Write tests/fixtures/torch_parity_demo.npz: a seeded synthetic pan and the
JAX package's CLI output for it, the reference the PyTorch port is held to
on a card (chip_smoke.py) and on the CPU (tests/test_torch_cli.py).

The JAX CLI runs on the CPU with the bundled demo model and flow estimator
(--model_vid demo --flow_model bundled --flow_scale 0.5, float32).

  JAX_PLATFORMS=cpu python tools/make_torch_parity_fixture.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_parity_demo.npz")

SEED = 20261016
FRAMES, H, W = 5, 96, 128
STEP = (3, 2)            # pan per frame (dx, dy) in pixels


def pan_frames(seed: int, n: int, h: int, w: int, step=STEP) -> np.ndarray:
    """n uint8 (h, w, 3) frames of a smooth random texture panned by
    `step` pixels per frame: frame t at (y, x) shows frame t-1 at
    (y + dy, x + dx), a backward flow of exactly (dx, dy)."""
    rng = np.random.default_rng(seed)
    sx, sy = step
    ch, cw = h + n * abs(sy) + 8, w + n * abs(sx) + 8
    y0, x0 = max(0, -sy) * (n - 1), max(0, -sx) * (n - 1)
    canvas = rng.random((ch + 8, cw + 8, 3))
    for _ in range(2):                       # 9x9 box blur, twice
        c = np.cumsum(np.cumsum(canvas, 0), 1)
        c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
        canvas = (c[9:, 9:] - c[:-9, 9:] - c[9:, :-9] + c[:-9, :-9]) / 81.0
    canvas = (canvas - canvas.min()) / (canvas.max() - canvas.min())
    u8 = np.round(canvas * 255).astype(np.uint8)
    return np.stack([u8[y0 + t * sy:y0 + t * sy + h, x0 + t * sx:x0 + t * sx + w]
                     for t in range(n)])


def run_jax_cli(frames: np.ndarray, workdir: str) -> np.ndarray:
    """The JAX CLI's uint8 outputs for `frames` (the zero-download path)."""
    from fast_artistic_videos_tpu.cli import stylize_video
    from fast_artistic_videos_tpu.core import io

    for t, f in enumerate(frames, 1):
        io.write_ppm(os.path.join(workdir, f"frame_{t:05d}.ppm"), f)
    prefix = os.path.join(workdir, "out", "o")
    stylize_video.main([
        "--input_pattern", os.path.join(workdir, "frame_%05d.ppm"),
        "--model_vid", "demo", "--flow_model", "bundled", "--flow_scale", "0.5",
        "--output_prefix", prefix])
    return np.stack([io.load_image_u8(f"{prefix}-{t:05d}.png")
                     for t in range(1, len(frames) + 1)])


def main():
    frames = pan_frames(SEED, FRAMES, H, W)
    with tempfile.TemporaryDirectory() as d:
        outputs = run_jax_cli(frames, d)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, seed=np.int64(SEED), step=np.asarray(STEP),
                        frames=frames, outputs=outputs)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
