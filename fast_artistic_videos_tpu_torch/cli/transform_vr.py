"""CLI: split equirectangular video frames into 6 overlapping cube faces —
the PyTorch port's copy of ``fast_artistic_videos_tpu/cli/transform_vr.py``
(the projection is the port's ``video.vr_geometry``, on the CPU), the
equivalent of transformVRVideo.sh (which shells out to Facebook's
Transform360 ffmpeg filter; here the projection is computed directly).

Output naming matches the VR driver's --input_pattern contract
(frame index, face number 1..6).
"""

from __future__ import annotations

import argparse
import os

from ..core import io
from ..video import vr_geometry as vr


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_pattern", required=True,
                   help="equirect frames, e.g. equi_%%05d.png")
    p.add_argument("--output_pattern", required=True,
                   help="face output, e.g. faces/f%%04d_%%d.ppm")
    p.add_argument("--face_size", type=int, default=768,
                   help="face size WITHOUT overlap")
    p.add_argument("--overlap_pixel_w", type=int, default=20)
    p.add_argument("--overlap_pixel_h", type=int, default=20)
    p.add_argument("--start", type=int, default=1)
    args = p.parse_args(argv)

    hplus = args.face_size + args.overlap_pixel_h
    wplus = args.face_size + args.overlap_pixel_w
    i = args.start
    count = 0
    while True:
        path = args.input_pattern % i
        if not os.path.exists(path):
            break
        equi = io.load_image(path)
        faces = vr.equirect_to_faces(
            equi, hplus, wplus, args.overlap_pixel_w, args.overlap_pixel_h
        )
        for number, img in faces.items():
            io.save_image(args.output_pattern % (i, number), img.clip(0, 1))
        count += 1
        i += 1
    print(f"{count} frames split into faces")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
