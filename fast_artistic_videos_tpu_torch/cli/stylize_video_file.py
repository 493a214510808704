"""CLI: one-command video stylization with the PyTorch port — counterpart
of ``fast_artistic_videos_tpu/cli/stylize_video_file.py`` (the reference's
``stylizeVideo_*.sh``), with ``--device`` (default ``cuda``).

Pipeline: ffmpeg decode -> optical flow (streaming on the device by
default; or, with --flow_background, a concurrent flow-file producer,
``cli.make_opt_flow``, like the reference's background job, :80-82) ->
temporally consistent stylization (``cli.stylize_video``) -> ffmpeg encode.
The ffmpeg steps are skipped with --frames_dir / --no_encode. The
background producer runs on the stylizer's ``--device``: processes share
a card (the JAX CLI puts its producer on the CPU instead).

Examples:
  python -m fast_artistic_videos_tpu_torch.cli.stylize_video_file video.mp4 \\
      --model_vid candy-video.npz --flow_model bundled
  python -m fast_artistic_videos_tpu_torch.cli.stylize_video_file \\
      --frames_dir frames --model_vid demo --flow_model bundled --no_encode
  python -m fast_artistic_videos_tpu_torch.cli.stylize_video_file \\
      --frames_dir frames --model_vid demo --flow_model bundled --flow_background
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _ffmpeg():
    ff = shutil.which("ffmpeg") or shutil.which("avconv")
    if ff is None:
        raise SystemExit(
            "ffmpeg/avconv not found — decode the video yourself and pass --frames_dir"
        )
    return ff


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("video", nargs="?", default="", help="input video file")
    p.add_argument("--frames_dir", default="", help="pre-extracted frame_%%05d.ppm dir")
    p.add_argument("--model_vid", required=True)
    p.add_argument("--model_img", default="self")
    p.add_argument("--flow_model", default="", help="flow weights (.npz) or 'bundled'")
    p.add_argument("--flow_background", action="store_true",
                   help="produce flow files in a concurrent process (reference-style) "
                        "instead of streaming in-process")
    p.add_argument("--out_dir", default="")
    p.add_argument("--resolution", default="", help="w:h decode scaling")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--no_encode", action="store_true")
    p.add_argument("--fps", type=float, default=24.0)
    p.add_argument("--feature_reuse", type=int, default=0,
                   help="keyframe interval for the lossy high-fps mode "
                        "(0 = off; see cli.stylize_video)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    if not args.video and not args.frames_dir:
        p.error("give a video file or --frames_dir")
    if not args.flow_model:
        p.error("need --flow_model (streaming flow on the device) — external "
                "flow files can be used directly via cli.stylize_video patterns")

    if args.frames_dir:
        workdir = args.out_dir or os.path.dirname(os.path.abspath(args.frames_dir))
        frames_dir = args.frames_dir
    else:
        base = os.path.splitext(os.path.basename(args.video))[0].replace("%", "x")
        workdir = args.out_dir or base
        frames_dir = os.path.join(workdir, "frames")
        os.makedirs(frames_dir, exist_ok=True)
        cmd = [_ffmpeg(), "-nostdin", "-loglevel", "error", "-i", args.video]
        if args.resolution:
            cmd += ["-vf", f"scale={args.resolution}"]
        cmd += [os.path.join(frames_dir, "frame_%05d.ppm")]
        print("decoding:", " ".join(cmd))
        subprocess.run(cmd, check=True)

    input_pattern = os.path.join(frames_dir, "frame_%05d.ppm")
    out_prefix = os.path.join(workdir, "out")
    stylize_args = [
        "--model_vid", args.model_vid,
        "--model_img", args.model_img,
        "--input_pattern", input_pattern,
        "--output_prefix", out_prefix,
        "--dtype", args.dtype,
        "--feature_reuse", str(args.feature_reuse),
        "--device", args.device,
    ]
    flow_proc = None
    if args.flow_background:
        flow_dir = os.path.join(workdir, "flow")
        # concurrent producer; the stylizer polls for its files, exactly like
        # the reference's background makeOptFlow job
        flow_proc = subprocess.Popen(
            [sys.executable, "-m", "fast_artistic_videos_tpu_torch.cli.make_opt_flow",
             "--input_pattern", input_pattern, "--out_dir", flow_dir,
             "--flow_model", args.flow_model, "--device", args.device],
        )
        stylize_args += [
            "--flow_pattern", os.path.join(flow_dir, "backward_[%d]_{%d}.flo"),
            "--occlusions_pattern", os.path.join(flow_dir, "reliable_[%d]_{%d}.pgm"),
        ]
    else:
        stylize_args += ["--flow_model", args.flow_model]

    from . import stylize_video

    try:
        rc = stylize_video.main(stylize_args)
    except BaseException:
        if flow_proc is not None:
            flow_proc.kill()      # the producer dies with the stylizer
        raise
    finally:
        if flow_proc is not None:
            flow_proc.wait()
    if rc != 0:
        return rc

    if not args.no_encode and args.video:
        out_video = os.path.join(workdir, "stylized.mp4")
        subprocess.run(
            [_ffmpeg(), "-nostdin", "-loglevel", "error", "-y",
             "-framerate", str(args.fps), "-i", out_prefix + "-%05d.png", out_video],
            check=True,
        )
        print(f"wrote {out_video}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
