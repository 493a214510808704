"""CLI: mine high-motion frame tuples from scene directories and emit a
flow-computation job list — the PyTorch port's copy of
``fast_artistic_videos_tpu/cli/make_flow_list.py`` (numpy only), the
equivalent of video_dataset/make_flow_list.py
(reference behavior: extract frames at 384x256, rank in-scene frame tuples
by mean absolute frame difference, keep the top n_tuples per scene, list
bidirectional flow jobs with the first pair of each tuple prefixed ``s_``,
delete unused frames; :43-81).

Video decoding requires ffmpeg; when scenes are already frame directories
(--frames_ready) no external tool is needed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

from ..core import io


def extract_frames(video_path: str, out_dir: str, width: int, height: int) -> None:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found; pre-extract frames and use --frames_ready"
        )
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", video_path,
         "-vf", f"scale={width}:{height}", os.path.join(out_dir, "frame_%05d.ppm")],
        check=True,
    )


def frame_motion(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a - b)))


def mine_scene(frame_dir: str, n_tuples: int, n_frames: int):
    """Rank consecutive n_frames tuples by motion of their first pair;
    returns start indices of the selected tuples (1-based)."""
    names = sorted(
        f for f in os.listdir(frame_dir) if f.startswith("frame_") and f.endswith(".ppm")
    )
    if len(names) < n_frames:
        return [], names
    frames = [io.load_image(os.path.join(frame_dir, n)) for n in names]
    scores = []
    for s in range(len(frames) - n_frames + 1):
        scores.append((frame_motion(frames[s], frames[s + 1]), s + 1))
    scores.sort(reverse=True)
    chosen = sorted(s for _, s in scores[:n_tuples])
    return chosen, names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir", help="directory of scene videos or frame dirs")
    p.add_argument("out_list", help="output flow job list file")
    p.add_argument("n_tuples", type=int, nargs="?", default=10)
    p.add_argument("n_frames", type=int, nargs="?", default=2,
                   help="frames per tuple (sequence_length)")
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--frames_ready", action="store_true",
                   help="scenes are already frame_%%05d.ppm directories")
    p.add_argument("--delete_unused", action="store_true")
    args = p.parse_args(argv)

    jobs = []
    for entry in sorted(os.listdir(args.input_dir)):
        path = os.path.join(args.input_dir, entry)
        if os.path.isdir(path):
            frame_dir = path
        elif entry.lower().endswith((".avi", ".mp4", ".mkv", ".mov")):
            frame_dir = os.path.join(args.input_dir, os.path.splitext(entry)[0])
            if not args.frames_ready:
                extract_frames(path, frame_dir, args.width, args.height)
        else:
            continue
        starts, names = mine_scene(frame_dir, args.n_tuples, args.n_frames)
        used = set()
        for s in starts:
            for k in range(args.n_frames - 1):
                i, j = s + k, s + k + 1
                prefix = "s_" if k == 0 else ""
                jobs.append(f"{frame_dir} {prefix}{i}_{j}")
                used.update((i, j))
        if args.delete_unused:
            for idx, name in enumerate(names, start=1):
                if idx not in used:
                    os.remove(os.path.join(frame_dir, name))
    with open(args.out_list, "w") as f:
        f.write("\n".join(jobs) + ("\n" if jobs else ""))
    print(f"{len(jobs)} flow jobs -> {args.out_list}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
