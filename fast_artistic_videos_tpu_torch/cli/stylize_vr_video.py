"""CLI: stylize a spherical (360°) video given as 6 overlapping cube faces
with the PyTorch port — counterpart of
``fast_artistic_videos_tpu/cli/stylize_vr_video.py``, with the same flags
(generated from ``VROptions``) plus ``--device`` (default ``cuda``; there is
no silent fallback to the CPU).

The input pattern takes two integers (frame, face), e.g.
``faces/f%04d_%d.ppm``; the flow and occlusion patterns take the [%d]/{%d}
frame placeholders plus a trailing %d for the face. Zero-download example
(bundled demo model and flow estimator; faces of at least 41 px):

  python -m fast_artistic_videos_tpu_torch.cli.stylize_vr_video \\
      --input_pattern faces/f%04d_%d.ppm --model_vid demo \\
      --flow_model bundled --flow_scale 0.5 --output_prefix out/o

``--evaluate`` scores every face (seam gradient ratios, cross-face edge
error, style, content and temporal error) on the stylizer's device and
appends the seven series and their means to ``--evaluation_file``.

The port's float32 convs and matrix products run with TF32 off
(``core.device.float32_convs``).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..video.driver_vr import VRDriver, VROptions
from .stylize_video import build_engine, resolve_device


def _optional_bool(text: str) -> bool:
    if text.lower() in ("1", "true", "yes"):
        return True
    if text.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true or false, got {text!r}")


def parse_options(argv=None):
    """(VROptions, device name) from the command line."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    defaults = VROptions()
    for f in dataclasses.fields(VROptions):
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument("--" + f.name, action="store_true", default=default)
        elif default is None:           # pallas_strip_warp: unset, true or false
            p.add_argument("--" + f.name, type=_optional_bool, default=None)
        else:
            p.add_argument("--" + f.name, type=type(default), default=default)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    opt = VROptions(**{f.name: getattr(args, f.name) for f in dataclasses.fields(VROptions)})
    if not opt.input_pattern:
        p.error("--input_pattern is required")
    if (not opt.create_inconsistent and not opt.flow_model
            and (not opt.flow_pattern or not opt.occlusions_pattern)):
        p.error("--flow_pattern and --occlusions_pattern are required "
                "(or pass --flow_model for streaming flow, or --create_inconsistent)")
    return opt, args.device


def build_flow_provider(opt: VROptions, device):
    """All 6 face flows of a frame in one batched step (the faces are
    independent temporal streams)."""
    from ..flow import family
    from ..flow.provider import BatchedStreamingFlowProvider

    est = family.load_estimator(
        opt.flow_model, dtype=torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32,
        device=device)
    return BatchedStreamingFlowProvider(flow_estimator=est, flow_scale=opt.flow_scale,
                                        fast_check=opt.fast_check)


def build_evaluator(opt: VROptions, device):
    """The --evaluate scorer on the stylizer's device, or None."""
    if not opt.evaluate:
        return None
    from ..video.evaluation import VREvaluator

    return VREvaluator(opt, device)


def main(argv=None):
    opt, device_name = parse_options(argv)
    device = resolve_device(device_name)
    engine = build_engine(opt, device)
    flow = build_flow_provider(opt, device) if opt.flow_model else None
    n = VRDriver(engine, opt, eval_fn=build_evaluator(opt, device),
                 batched_flow_provider=flow).run()
    print(f"processed {n} faces ({n // 6} full frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
