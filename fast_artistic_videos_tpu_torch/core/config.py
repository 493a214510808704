"""Config dataclasses and the reference's five string mini-DSL parsers.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/core/config.py`` (numpy and the standard
library only): the port imports nothing of the JAX package.

The Torch reference embeds five small string DSLs in its CLI surface
(SURVEY.md §5 "Config / flag system"); they are reimplemented here as pure
parsers so every CLI keeps flag-level parity:

  1. arch strings          ``c9s1-32,d64,R128,u64,...``
     (reference: models_video.lua:55-115) — parsed in
     :mod:`fast_artistic_videos_tpu_torch.models.arch_dsl`.
  2. data-mix weights      ``video:3,shift:1`` (train_video.lua:158-167)
  3. iteration schedules   ``0:1,50000:2`` for frame steps; ``1e-3`` or
     ``1e-3,50000:5e-4`` for learning rate (train_video.lua:169-189)
  4. layer/weight lists    ``4,9,16,23`` with scalar weight broadcast
     (fast_artistic_video/utils.lua:25-40)
  5. flow filename patterns with ``[%d]``/``{%d}`` placeholders
     (fast_artistic_video.lua:70-77)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple


# ---------------------------------------------------------------------------
# DSL 2: data-mix roulette wheel — "video:3,shift:1,zoom_out:1"
# ---------------------------------------------------------------------------

def parse_data_mix(s: str) -> Dict[str, int]:
    """Parse a data-mix string into an ordered {source: count} dict."""
    out: Dict[str, int] = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        if not count:
            raise ValueError(f"data-mix entry {part!r} must be 'name:count'")
        out[name.strip()] = int(count)
    if not out:
        raise ValueError(f"empty data mix: {s!r}")
    return out


def data_mix_wheel(mix: Dict[str, int]) -> List[str]:
    """Expand a data mix into the roulette wheel list (train_video.lua:163)."""
    wheel: List[str] = []
    for name, count in mix.items():
        wheel.extend([name] * count)
    return wheel


# ---------------------------------------------------------------------------
# DSL 3: iteration-keyed schedules — "0:1,50000:2,60000:4"
# ---------------------------------------------------------------------------

def parse_iter_schedule(s: str) -> List[Tuple[int, float]]:
    """Parse "iter:value,..." into a sorted list of (iter, value) breakpoints."""
    out: List[Tuple[int, float]] = []
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        it, _, val = part.partition(":")
        if not val:
            raise ValueError(f"schedule entry {part!r} must be 'iter:value'")
        out.append((int(it), float(val)))
    return sorted(out)


def parse_lr_schedule(s: str) -> List[Tuple[int, float]]:
    """Parse a learning-rate string: first entry is a bare rate, the rest are
    "iter:rate" (train_video.lua:179-189). "1e-3" or "1e-3,50000:5e-4"."""
    parts = [p.strip() for p in str(s).split(",") if p.strip()]
    if not parts:
        raise ValueError("empty learning-rate schedule")
    sched = [(0, float(parts[0]))]
    for part in parts[1:]:
        it, _, val = part.partition(":")
        if not val:
            raise ValueError(f"lr entry {part!r} must be 'iter:rate'")
        sched.append((int(it), float(val)))
    return sched


def schedule_value(sched: Sequence[Tuple[int, float]], iteration: int) -> float:
    """Evaluate a schedule with the reference's semantics: the value of the
    last breakpoint whose iter is strictly below the current iteration
    (train_video.lua:254-256, 400-402: ``if iteration > entry.iter``)."""
    value = sched[0][1]
    for it, val in sched:
        if iteration > it:
            value = val
        else:
            break
    return value


# ---------------------------------------------------------------------------
# DSL 4: layer/weight lists — layers "4,9,16,23", weights "1.0" or "1,2,3,4"
# ---------------------------------------------------------------------------

def parse_num_list(s: str) -> List[float]:
    return [float(p) for p in str(s).split(",") if p.strip()]


def parse_layers(layers_string: str, weights_string: str) -> Tuple[List[str], List[float]]:
    """Parse layer id strings and weights; broadcast a scalar weight
    (reference: utils.lua:25-40)."""
    layers = [p.strip() for p in str(layers_string).split(",") if p.strip()]
    weights = parse_num_list(weights_string)
    if len(weights) == 1 and len(layers) > 1:
        weights = weights * len(layers)
    if len(weights) != len(layers):
        raise ValueError(
            f"size mismatch between layers {layers_string!r} and weights {weights_string!r}"
        )
    return layers, weights


# ---------------------------------------------------------------------------
# DSL 5: flow-file patterns — "flow/backward_[%d]_{%d}.flo"
# ---------------------------------------------------------------------------

_CURLY = re.compile(r"\{([^}]*)\}")
_SQUARE = re.compile(r"\[([^\]]*)\]")


def _lua_format(fmt: str, value: int) -> str:
    """Apply a Lua/C-style %d-ish format to an integer."""
    return fmt % value


def format_flow_name(pattern: str, from_index: int, to_index: int) -> str:
    """Format a flow/occlusion filename pattern.

    ``{...}`` is substituted with *from_index*, ``[...]`` with *to_index*,
    each interior treated as a printf format — reference
    getFormatedFlowFileName (fast_artistic_video.lua:70-77).

    >>> format_flow_name('flow/backward_[%d]_{%d}.flo', 3, 4)
    'flow/backward_4_3.flo'
    """
    out = _CURLY.sub(lambda m: _lua_format(m.group(1), from_index), pattern)
    out = _SQUARE.sub(lambda m: _lua_format(m.group(1), to_index), out)
    return out


# ---------------------------------------------------------------------------
# Option dataclasses (shared between drivers; CLIs expose them as flags)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StylizeOptions:
    """Options for the generic stylization engine.

    Field-for-field parity with the reference's engine options
    (fast_artistic_video_core.lua:17-33 and fast_artistic_video.lua:23-67),
    minus GPU/backend plumbing (JAX owns device placement).
    """

    model_img: str = ""                 # '' or 'self' => stylize frame 1 with the video model
    model_vid: str = ""
    num_frames: int = 9999
    continue_with: int = 1
    input_pattern: str = ""
    output_prefix: str = "out"
    flow_pattern: str = ""
    occlusions_pattern: str = ""
    invert_occlusion: bool = False
    occlusions_min_filter: int = 7
    fill_occlusions: str = "vgg-mean"   # 'vgg-mean' | 'uniform-random'
    fix_occlusions: bool = False
    median_filter: int = 3
    scale_factor: float = 1.0
    backward: bool = False
    create_inconsistent: bool = False
    inconsistent_batch: int = 1         # frames per device step when
                                        # create_inconsistent (no recurrence)
    # numerics
    dtype: str = "float32"              # compute dtype: 'float32' | 'bfloat16'
    exact_warp: bool = False            # gather warp (exact) vs banded TPU warp
    flow_model: str = ""                # on-TPU flow estimator weights (.npz);
                                        # replaces flow/occlusion file patterns
    flow_scale: float = 1.0             # estimate flow at reduced resolution
    coarse_backward: bool = False       # refine the backward direction one
                                        # level less (speed knob; ~4.6% more
                                        # pixels conservatively flagged)
    fast_check: bool = False            # cross-check direction from a
                                        # negated-primary init, one refined
                                        # level (speed knob, ~20% cheaper
                                        # pair; keeps MORE pixels — ledger
                                        # in BENCH_NOTES "fast cross-check")
    flow_device: int = -1               # pin the flow stage to a device index
    phase_resident: bool = False        # keep the whole per-frame device
                                        # path (recurrence, warp, cert
                                        # erosion, net) in the 16-phase
                                        # quarter-res layout — no full-res
                                        # tensor on device per frame.
                                        # Needs --flow_model with
                                        # 0 < flow_scale < 1, frame H,W % 4
                                        # == 0, vgg-mean fill, no
                                        # scale_factor/exact_warp/
                                        # feature_reuse (full-chain A/B in
                                        # BENCH_NOTES round 5)
    feature_reuse: int = 0              # keyframe interval for the lossy
                                        # high-fps mode: every Kth frame runs
                                        # the full net, in-between frames
                                        # advect the residual-chain features
                                        # by flow (0/1 = off, exact). Pays
                                        # only when the residual chain
                                        # outweighs the quarter-grid delta
                                        # warp — i.e. deeper/wider arches,
                                        # NOT higher resolution (measured
                                        # fps-neutral at 1080p AND 4K on the
                                        # canonical net; BENCH_NOTES)
    # evaluation
    evaluate: bool = False
    flow_pattern_eval: str = ""
    occlusions_pattern_eval: str = ""
    invert_occlusion_eval: bool = False
    fix_occlusions_eval: bool = False
    backward_eval: bool = False
    evaluation_file: str = "evaluation.txt"
    content_weights: str = "1.0"
    content_layers: str = "16"
    loss_network: str = ""
    style_image: str = ""
    style_image_size: int = 256
    style_weights: str = "1.0"
    style_layers: str = "4,9,16,23"
    style_target_type: str = "gram"     # 'gram' | 'mean'


@dataclasses.dataclass
class TrainOptions:
    """Training options (reference: train_video.lua:20-78)."""

    arch: str = "c9s1-32,d64,d128,R128,R128,R128,R128,R128,u64,u32,c9s1-3"
    use_instance_norm: bool = True
    h5_file: str = ""
    h5_file_video: str = ""
    padding_type: str = "reflect-start"
    tanh_constant: float = 150.0
    preprocessing: str = "vgg"
    resume_from_checkpoint: str = ""
    image_model: str = ""               # '' => none, 'self' => recurrent bootstrap

    data_mix: str = "shift:1,zoom_out:1,video:3"
    num_frame_steps: str = "0:1"
    reliable_map_min_filter: int = 7
    fill_occlusions: str = "vgg-mean"
    train_img_size: str = "256:256"
    single_image_until: int = 0

    pixel_loss_type: str = "L2"         # 'L2' | 'L1' | 'SmoothL1'
    pixel_loss_weight: float = 50.0
    percep_loss_weight: float = 1.0
    tv_strength: float = 1e-6

    content_weights: str = "1.0"
    content_layers: str = "16"
    loss_network: str = ""
    style_image: str = ""
    style_image_size: int = 384
    style_weights: str = "10.0"
    style_layers: str = "4,9,16,23"
    style_target_type: str = "gram"

    num_iterations: int = 60000
    batch_size: int = 4
    learning_rate: str = "1e-3"
    lr_decay_every: int = -1
    lr_decay_factor: float = 0.5
    weight_decay: float = 0.0

    max_train: int = 0                  # cap the train split (the reference
                                        # loaders read opt.max_train, an
                                        # undeclared CLI option there)
    checkpoint_name: str = "checkpoint"
    checkpoint_every: int = 1000
    history_every: int = 100
    num_val_batches: int = 100
    images_every: int = 100
    print_every: int = 10

    # TPU-native additions (no reference analog)
    dtype: str = "float32"              # compute dtype for the model
    full_bptt: bool = False             # reference backprops only the last step
    seed: int = 0
    num_data_devices: int = 1           # data-parallel shards over the mesh
