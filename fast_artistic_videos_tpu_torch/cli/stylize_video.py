"""CLI: stylize a frame sequence into a temporally consistent stylized
sequence with the PyTorch port — counterpart of
``fast_artistic_videos_tpu/cli/stylize_video.py``, with the same flags
(``StylizeOptions``) plus ``--device`` (default ``cuda``; there is no silent
fallback to the CPU).

Zero-download example (bundled demo model and flow estimator):

  python -m fast_artistic_videos_tpu_torch.cli.stylize_video \\
      --input_pattern frames/frame_%05d.ppm --model_vid demo \\
      --flow_model bundled --flow_scale 0.5 --output_prefix out/o

Every flag of the JAX CLI is carried. ``--evaluate`` scores every frame
(style, content and temporal error against ``--loss_network``,
``--style_image`` and the ground-truth ``--flow_pattern_eval`` /
``--occlusions_pattern_eval``) on the same device as the stylizer, and
appends the series and their means to ``--evaluation_file``.
``--phase_resident`` keeps the JAX CLI's validation and runs the plain path: the 16-phase quarter-resolution
layout is a TPU layout, and the JAX package holds the two modes to within
one uint8 step of each other.

The port's float32 convs and matrix products run with TF32 off whatever
the caller's flags say (``core.device.float32_convs``), so float32 numbers
are float32.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..core.config import StylizeOptions
from ..models import checkpoint, stylizer
from ..video.driver_video import VideoDriver
from ..video.engine import EngineConfig, StylizerEngine


def add_stylize_flags(p: argparse.ArgumentParser) -> None:
    defaults = StylizeOptions()
    for f in dataclasses.fields(StylizeOptions):
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument("--" + f.name, action="store_true", default=default)
        else:
            p.add_argument("--" + f.name, type=type(default), default=default)


def options_from_args(args) -> StylizeOptions:
    return StylizeOptions(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(StylizeOptions)})


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    return dev


def build_engine(opt: StylizeOptions, device) -> StylizerEngine:
    spec_v, params_v, _ = checkpoint.load_model(opt.model_vid, device)
    apply_vid = lambda p, x: stylizer.apply(p, spec_v, x)  # noqa: E731
    apply_img = params_img = None
    stride = spec_v.total_stride
    if opt.model_img not in ("", "self"):
        spec_i, params_img, _ = checkpoint.load_model(opt.model_img, device)
        apply_img = lambda p, x: stylizer.apply(p, spec_i, x)  # noqa: E731
        stride = max(stride, spec_i.total_stride)
    cfg = EngineConfig(fill_occlusions=opt.fill_occlusions,
                       occlusions_min_filter=opt.occlusions_min_filter,
                       dtype=opt.dtype, exact_warp=opt.exact_warp)
    if opt.phase_resident and not stylizer.supports_phase_io(spec_v):
        raise SystemExit("--phase_resident: this architecture does not support "
                         "phase-io (needs stride-4 with 4-aligned input padding)")
    # the segment-capable apply and the split plan enable --feature_reuse
    plan = stylizer.reuse_split_plan(spec_v)
    split = None
    if plan is not None:
        split = lambda p, x, **kw: stylizer.apply(p, spec_v, x, **kw)  # noqa: E731
    return StylizerEngine(apply_vid, params_v, apply_img, params_img,
                          stride_multiple=stride, config=cfg, device=device,
                          apply_vid_split=split, reuse_plan=plan)


def flow_stage_device(flow_device: int, device: torch.device) -> torch.device:
    """The flow stage's device: card `flow_device` when ``0 <= flow_device <
    torch.cuda.device_count()`` and the run is on the cards, else `device`
    (the JAX CLI's rule for ``--flow_device``)."""
    if device.type == "cuda" and 0 <= flow_device < torch.cuda.device_count():
        return torch.device("cuda", flow_device)
    return device


def build_flow_provider(opt: StylizeOptions, device):
    from ..flow import family
    from ..flow.provider import StreamingFlowProvider

    device = flow_stage_device(opt.flow_device, device)
    # flow_scale < 1: the provider erodes the certainty at flow resolution
    # (exact), and the engine skips its full-resolution min-filter — but not
    # when the certainty is resized (scale_factor) or reaches the reuse steps,
    # which erode it themselves (the JAX CLI's conditions)
    erode_window = (opt.occlusions_min_filter
                    if (0 < opt.flow_scale < 1.0 and opt.scale_factor == 1.0
                        and opt.feature_reuse <= 1 and not opt.phase_resident)
                    else None)
    est = family.load_estimator(
        opt.flow_model, dtype=torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32,
        device=device)
    return StreamingFlowProvider(
        flow_estimator=est, flow_scale=opt.flow_scale, coarse_backward=opt.coarse_backward,
        fast_check=opt.fast_check, erode_window=erode_window)


def build_evaluator(opt: StylizeOptions, device):
    """The --evaluate scorer on the stylizer's device, or None."""
    if not opt.evaluate:
        return None
    from ..video.evaluation import VideoEvaluator

    return VideoEvaluator(opt, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_stylize_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    opt = options_from_args(args)
    if not opt.input_pattern:
        p.error("--input_pattern is required")
    if (not opt.create_inconsistent and not opt.flow_model
            and (not opt.flow_pattern or not opt.occlusions_pattern)):
        p.error("--flow_pattern and --occlusions_pattern are required "
                "(or pass --flow_model for streaming flow, or --create_inconsistent)")
    if opt.phase_resident:
        if not opt.flow_model or not (0 < opt.flow_scale < 1.0):
            p.error("--phase_resident needs --flow_model with "
                    "0 < --flow_scale < 1 (the JAX CLI's phased flow lives "
                    "at estimation resolution)")
        if (opt.scale_factor != 1.0 or opt.feature_reuse > 1
                or opt.exact_warp or opt.fill_occlusions != "vgg-mean"
                or opt.create_inconsistent):
            p.error("--phase_resident is incompatible with --scale_factor, "
                    "--feature_reuse, --exact_warp, --create_inconsistent "
                    "and non-default --fill_occlusions")
    device = resolve_device(args.device)
    engine = build_engine(opt, device)
    flow_provider = build_flow_provider(opt, device) if opt.flow_model else None
    results = VideoDriver(engine, opt, eval_fn=build_evaluator(opt, device),
                          flow_provider=flow_provider).run()
    if results:
        total = sum(r.seconds for r in results)
        print(f"{len(results)} frames in {total:.2f}s "
              f"({len(results) / max(total, 1e-9):.2f} fps, host clock)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
