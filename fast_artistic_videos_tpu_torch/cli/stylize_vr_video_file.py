"""CLI: one-command spherical (360°) video stylization with the PyTorch
port — counterpart of ``fast_artistic_videos_tpu/cli/stylize_vr_video_file.py``,
with ``--device`` (default ``cuda``; there is no silent fallback to the
CPU). It is the equivalent of running ``./transformVRVideo.sh`` +
``./stylizeVRVideo_*.sh <video> <model>`` (transformVRVideo.sh:17-24 chains Transform360 reprojection into
stylizeVRVideo_flownet.sh:16-98's flow + stylization + encode).

Pipeline, end to end in one invocation:
  1. ffmpeg decode equirect video -> equi_%05d.ppm     (skipped w/ --frames_dir)
  2. direct equirect->cubemap projection into 6 overlapping faces
     (video.vr_geometry.equirect_to_faces replaces Transform360)
  3. streaming flow for all six faces + cross-face-consistent stylization
     (the port's cli.stylize_vr_video with --flow_model, on --device),
     writing equirect output frames
  4. ffmpeg encode the stylized equirect frames         (skipped w/ --no_encode)

Examples:
  python -m fast_artistic_videos_tpu_torch.cli.stylize_vr_video_file sphere.mp4 \\
      --model_vid candy-vr.npz --flow_model bundled --face_size 768
  python -m fast_artistic_videos_tpu_torch.cli.stylize_vr_video_file \\
      --frames_dir equi --model_vid demo --flow_model bundled --no_encode
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from ..core import io
from ..video import vr_geometry as vr


def _ffmpeg():
    ff = shutil.which("ffmpeg") or shutil.which("avconv")
    if ff is None:
        raise SystemExit(
            "ffmpeg/avconv not found — decode the video yourself and pass --frames_dir"
        )
    return ff


def split_faces(input_pattern: str, output_pattern: str, face_size: int,
                overlap_w: int, overlap_h: int, start: int = 1,
                limit: int = 0):
    """Equirect frames -> 6 overlapping cube faces each; returns the frame
    count and the (H, W) of the first equirect frame."""
    hplus = face_size + overlap_h
    wplus = face_size + overlap_w
    i, count, equi_hw = start, 0, None
    while True:
        path = input_pattern % i
        if not os.path.exists(path) or (limit and count >= limit):
            break
        equi = io.load_image(path)
        if equi_hw is None:
            equi_hw = equi.shape[:2]
        faces = vr.equirect_to_faces(equi, hplus, wplus, overlap_w, overlap_h)
        for number, img in faces.items():
            io.save_image(output_pattern % (i, number), img.clip(0, 1))
        count += 1
        i += 1
    return count, equi_hw


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("video", nargs="?", default="", help="input equirect video")
    p.add_argument("--frames_dir", default="",
                   help="pre-extracted equirect equi_%%05d.ppm dir (no ffmpeg)")
    p.add_argument("--model_vid", required=True)
    p.add_argument("--model_img", default="self")
    p.add_argument("--flow_model", default="", help="flow weights (.npz) or 'bundled'")
    p.add_argument("--flow_scale", type=float, default=1.0)
    p.add_argument("--face_size", type=int, default=768,
                   help="face size WITHOUT overlap (stylizeVRVideo_flownet.sh:82)")
    p.add_argument("--overlap_pixel_w", type=int, default=0,
                   help="0 = reference default: face_size/6 (:82-83)")
    p.add_argument("--overlap_pixel_h", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=0, help="0 = all")
    p.add_argument("--out_dir", default="")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--no_encode", action="store_true")
    p.add_argument("--keep_faces", action="store_true",
                   help="also keep the per-face stylized PNGs")
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--continue_with", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    if not args.video and not args.frames_dir:
        p.error("give a video file or --frames_dir")
    # reference default overlap: 1/6 of the face size (128 @ 768)
    overlap_w = args.overlap_pixel_w or max(4, args.face_size // 6)
    overlap_h = args.overlap_pixel_h or max(4, args.face_size // 6)

    if args.frames_dir:
        workdir = args.out_dir or os.path.dirname(os.path.abspath(args.frames_dir))
        equi_dir = args.frames_dir
    else:
        base = os.path.splitext(os.path.basename(args.video))[0].replace("%", "x")
        workdir = args.out_dir or base
        equi_dir = os.path.join(workdir, "equi")
        os.makedirs(equi_dir, exist_ok=True)
        cmd = [_ffmpeg(), "-nostdin", "-loglevel", "error", "-i", args.video,
               os.path.join(equi_dir, "equi_%05d.ppm")]
        print("decoding:", " ".join(cmd))
        subprocess.run(cmd, check=True)

    faces_dir = os.path.join(workdir, "faces")
    os.makedirs(faces_dir, exist_ok=True)
    equi_pattern = os.path.join(equi_dir, "equi_%05d.ppm")
    face_pattern = os.path.join(faces_dir, "f%04d_%d.ppm")
    n_frames, equi_hw = split_faces(
        equi_pattern, face_pattern, args.face_size, overlap_w, overlap_h,
        limit=args.num_frames)
    if n_frames == 0:
        raise SystemExit(f"no frames matched {equi_pattern}")
    print(f"{n_frames} equirect frames -> 6 faces each "
          f"({args.face_size}+{overlap_w}/{overlap_h} overlap)")

    out_prefix = os.path.join(workdir, "out")
    vr_args = [
        "--model_vid", args.model_vid,
        "--model_img", args.model_img,
        "--input_pattern", face_pattern,
        "--output_prefix", out_prefix,
        "--num_frames", str(n_frames),
        "--overlap_pixel_w", str(overlap_w),
        "--overlap_pixel_h", str(overlap_h),
        "--out_equi",
        "--out_equi_w", str(equi_hw[1]),
        "--out_equi_h", str(equi_hw[0]),
        "--dtype", args.dtype,
        "--device", args.device,
    ]
    if args.continue_with:
        vr_args += ["--continue_with", str(args.continue_with)]
    if args.flow_model:
        vr_args += ["--flow_model", args.flow_model,
                    "--flow_scale", str(args.flow_scale)]
    else:
        vr_args += ["--create_inconsistent"]
        print("note: no --flow_model; faces are stylized without temporal "
              "consistency (reference -create_inconsistent mode)")

    from . import stylize_vr_video

    rc = stylize_vr_video.main(vr_args)
    if rc != 0:
        return rc

    if not args.keep_faces:
        for f in range(1, n_frames + 1):
            for pos in range(6):
                path = f"{out_prefix}{f}_{pos}.png"
                if os.path.exists(path):
                    os.remove(path)

    if not args.no_encode and args.video:
        out_video = os.path.join(workdir, "stylized_equi.mp4")
        subprocess.run(
            [_ffmpeg(), "-nostdin", "-loglevel", "error", "-y",
             "-framerate", str(args.fps),
             # with --continue_with N the first equi frame is N, not 1
             "-start_number", str(args.continue_with or 1),
             "-i", out_prefix + "-%05d_equi.png", out_video],
            check=True,
        )
        print(f"wrote {out_video}")
    else:
        print(f"stylized equirect frames at {out_prefix}-NNNNN_equi.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
