"""Write the fixtures the PyTorch port is held to on a card (chip_smoke.py)
and on the CPU (tests/test_torch_cli.py, tests/test_torch_vr.py): seeded
synthetic pans and the JAX package's CLI outputs for them.

  * tests/fixtures/torch_parity_demo.npz: the 2D CLI (stylize_video) on a
    5-frame 96x128 pan;
  * tests/fixtures/torch_parity_vr.npz: the VR CLI (stylize_vr_video) on 3
    frames of 6 cube faces of 64x64 px, overlap 16: six pan streams, one per
    face, cut side by side from one wide pan;
  * tests/fixtures/torch_parity_batch.npz: the 2D CLI's other modes on a
    4-frame 84x112 pan (at least 41 px per side after --scale_factor 0.5):
    --create_inconsistent --inconsistent_batch 2, --feature_reuse 3,
    --scale_factor 0.5 and --phase_resident (BATCH_CASES);
  * tests/fixtures/torch_parity_train.npz: the JAX style trainer on the
    CPU (write_train): the canonical architecture at full width, 64x64
    images, batch 2, 3 iterations of shift:1,zoom_out:1, from parameters
    drawn by chip_smoke.py's seeded_params (a numpy law, so the port
    starts from the same ones), the EVAL_VGG_SEED VGG-16 and the bundled
    candy style image at 64 px; seeded uint8 images through chip_smoke.py's
    in-memory source (ArraySource), with its PARITY_* seeds and options.
    Stored: the per-iteration losses, the first
    iteration's per-leaf gradient L2 norms and the final parameters'
    per-leaf sums and absolute sums;
  * tests/fixtures/torch_parity_flow_eval.npz: the JAX
    flow.train.evaluate_heldout on the bundled flow weights at 192 px
    (write_flow_eval): per protocol (EPE mean, EPE max, pass-rate mean,
    pass-rate min);
  * tests/fixtures/torch_parity_eval.npz: the JAX evaluators' rows
    (VideoEvaluator, VREvaluator) on the content frames and stylized
    outputs stored in the demo and VR fixtures, with ground-truth pan flow
    and certainty for the temporal term, a VGG-16 made from EVAL_VGG_SEED
    (vgg_npz: the seed is stored, not the weights) and the bundled candy
    style image.

The JAX CLIs run on the CPU with the bundled demo model and flow estimator
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
OUT_VR = os.path.join(ROOT, "tests", "fixtures", "torch_parity_vr.npz")
OUT_BATCH = os.path.join(ROOT, "tests", "fixtures", "torch_parity_batch.npz")
OUT_EVAL = os.path.join(ROOT, "tests", "fixtures", "torch_parity_eval.npz")
OUT_TRAIN = os.path.join(ROOT, "tests", "fixtures", "torch_parity_train.npz")
OUT_FLOW_EVAL = os.path.join(ROOT, "tests", "fixtures", "torch_parity_flow_eval.npz")

SEED = 20261016
FRAMES, H, W = 5, 96, 128
STEP = (3, 2)            # pan per frame (dx, dy) in pixels
VR_SEED = 20261017
VR_FRAMES, VR_FACE, VR_OVERLAP = 3, 64, 16
VR_STEP = (4, 1)
BATCH_SEED = 20261018
BATCH_FRAMES, BATCH_H, BATCH_W = 4, 84, 112
# name -> (extra CLI flags, frames run)
BATCH_CASES = {
    "batch": (["--create_inconsistent", "--inconsistent_batch", "2"], 3),
    "reuse": (["--feature_reuse", "3"], 4),
    "scale": (["--scale_factor", "0.5"], 3),
    "phase": (["--phase_resident"], 3),
}
EVAL_VGG_SEED = 20261019
EVAL_STYLE_SIZE = 64
VR_ARGS = ["--model_vid", "demo", "--flow_model", "bundled", "--flow_scale", "0.5",
           "--overlap_pixel_w", str(VR_OVERLAP), "--overlap_pixel_h", str(VR_OVERLAP)]


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


def run_jax_cli(frames: np.ndarray, workdir: str, extra=()) -> np.ndarray:
    """The JAX CLI's uint8 outputs for `frames` (the zero-download path,
    plus the flags `extra`)."""
    from fast_artistic_videos_tpu.cli import stylize_video
    from fast_artistic_videos_tpu.core import io

    for t, f in enumerate(frames, 1):
        io.write_ppm(os.path.join(workdir, f"frame_{t:05d}.ppm"), f)
    prefix = os.path.join(workdir, "out", "o")
    stylize_video.main([
        "--input_pattern", os.path.join(workdir, "frame_%05d.ppm"),
        "--model_vid", "demo", "--flow_model", "bundled", "--flow_scale", "0.5",
        "--output_prefix", prefix, "--num_frames", str(len(frames)), *extra])
    return np.stack([io.load_image_u8(f"{prefix}-{t:05d}.png")
                     for t in range(1, len(frames) + 1)])


def vr_faces(seed: int = VR_SEED, n: int = VR_FRAMES, face: int = VR_FACE,
             step=VR_STEP) -> np.ndarray:
    """(n, 6, face, face, 3) uint8: frame t's six faces (face numbers 1..6
    at index 0..5), cut side by side from one pan 6 faces wide."""
    pans = pan_frames(seed, n, face, 6 * face, step)
    return np.stack([np.stack([p[:, k * face:(k + 1) * face] for k in range(6)])
                     for p in pans])


def write_vr_faces(faces: np.ndarray, workdir: str) -> str:
    """Write the faces as f%04d_%d.ppm (frame, face number); returns the
    input pattern."""
    from fast_artistic_videos_tpu.core import io

    for t, frame in enumerate(faces, 1):
        for k, img in enumerate(frame, 1):
            io.write_ppm(os.path.join(workdir, f"f{t:04d}_{k}.ppm"), img)
    return os.path.join(workdir, "f%04d_%d.ppm")


def read_vr_outputs(prefix: str, n: int) -> np.ndarray:
    """(n, 6, H, W, 3) uint8 output faces, index 1 = processing position."""
    from fast_artistic_videos_tpu.core import io

    return np.stack([np.stack([io.load_image_u8(f"{prefix}{t}_{pos}.png")
                               for pos in range(6)]) for t in range(1, n + 1)])


def run_jax_vr_cli(faces: np.ndarray, workdir: str) -> np.ndarray:
    """The JAX VR CLI's uint8 output faces for `faces` (the zero-download
    path)."""
    from fast_artistic_videos_tpu.cli import stylize_vr_video

    prefix = os.path.join(workdir, "out", "o")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    stylize_vr_video.main(["--input_pattern", write_vr_faces(faces, workdir),
                           "--output_prefix", prefix, *VR_ARGS])
    return read_vr_outputs(prefix, len(faces))


def vgg_npz(seed: int, path: str) -> str:
    """Write a full-width VGG-16 .npz (the t7 importer's layout, HWIO) made
    from a numpy seed: per conv in order, weights then bias uniform in
    (-s, s) with s = 1/sqrt(9 Cin), float32."""
    from fast_artistic_videos_tpu.models.vgg import VGG16_LAYOUT

    rng = np.random.default_rng(seed)
    flat = {}
    for idx, cin, cout in ((i, a, b) for i, op, a, b in VGG16_LAYOUT if op == "conv"):
        s = 1.0 / np.sqrt(9 * cin)
        flat[f"conv{idx:02d}/w"] = rng.uniform(-s, s, (3, 3, cin, cout)).astype(np.float32)
        flat[f"conv{idx:02d}/b"] = rng.uniform(-s, s, cout).astype(np.float32)
    np.savez(path, **flat)
    return path


def write_pan_flow(workdir: str, n: int, h: int, w: int, step, faces=()) -> tuple:
    """Ground truth of a pan_frames pan: the backward flow of frame t
    (t = 2..n) is exactly step = (dx, dy), certain where the sample lands
    inside the frame and 0 in the band the pan reveals. Written as
    backward_<t>_<t-1>.flo and reliable_<t>_<t-1>.pgm (one pair per face
    number with a _<face> suffix when `faces` is given); returns the flow
    and certainty patterns."""
    from fast_artistic_videos_tpu.core import io

    sx, sy = step
    flow = np.empty((h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = sx, sy
    ys, xs = np.mgrid[0:h, 0:w]
    cert = (((xs + sx) <= w - 1) & ((ys + sy) <= h - 1)).astype(np.uint8) * 255
    suffixes = [f"_{k}" for k in faces] or [""]
    for t in range(2, n + 1):
        for sfx in suffixes:
            io.write_flo(os.path.join(workdir, f"backward_{t}_{t - 1}{sfx}.flo"), flow)
            io.write_pgm(os.path.join(workdir, f"reliable_{t}_{t - 1}{sfx}.pgm"), cert)
    tail = "_%d" if faces else ""
    return (os.path.join(workdir, "backward_[%d]_{%d}" + tail + ".flo"),
            os.path.join(workdir, "reliable_[%d]_{%d}" + tail + ".pgm"))


def eval_options(vgg_path: str, style_path: str, flow_pattern: str, cert_pattern: str,
                 **extra) -> dict:
    """The evaluation flags of the fixture's runs (StylizeOptions /
    VROptions fields)."""
    return dict(evaluate=True, loss_network=vgg_path, style_image=style_path,
                style_image_size=EVAL_STYLE_SIZE, flow_pattern_eval=flow_pattern,
                occlusions_pattern_eval=cert_pattern, **extra)


def eval_cases(demo: dict, vr_fx: dict):
    """The evaluator calls the fixture scores: 2D ((i, content, stylized,
    prev_stylized), float32 [0, 1] numpy), and VR ((i, pos, faces of the
    frame by processing position, the previous frame's, the content face))."""
    from fast_artistic_videos_tpu.video.driver_vr import PROC_ORDER

    frames = demo["frames"].astype(np.float32) / 255.0
    outs = demo["outputs"].astype(np.float32) / 255.0
    cases_2d = [(t, frames[t - 1], outs[t - 1], outs[t - 2] if t > 1 else None)
                for t in range(1, len(frames) + 1)]
    faces = vr_fx["faces"].astype(np.float32) / 255.0
    vouts = vr_fx["outputs"].astype(np.float32) / 255.0
    cases_vr = [(f * 6 + pos + 1, pos, vouts[f], vouts[f - 1] if f else vouts[f],
                 faces[f][PROC_ORDER[pos] - 1])
                for f in range(len(faces)) for pos in range(6)]
    return cases_2d, cases_vr


def jax_eval_rows(demo: dict, vr_fx: dict, workdir: str, vgg_path: str):
    """The JAX evaluators' rows on the eval cases: (rows_2d (n, 3), rows_vr
    (6 n, 7))."""
    import types

    from fast_artistic_videos_tpu.core.config import StylizeOptions
    from fast_artistic_videos_tpu.models import registry
    from fast_artistic_videos_tpu.video import evaluation
    from fast_artistic_videos_tpu.video.driver_vr import VROptions, _Geometry

    style = registry.style_fixture("candy")
    n, h, w = demo["frames"].shape[:3]
    pats = write_pan_flow(workdir, n, h, w, tuple(int(v) for v in demo["step"]))
    ev = evaluation.VideoEvaluator(StylizeOptions(**eval_options(vgg_path, style, *pats)))
    cases_2d, cases_vr = eval_cases(demo, vr_fx)
    rows_2d = [ev(*case) for case in cases_2d]
    nv, _, face = vr_fx["faces"].shape[:3]
    overlap = int(vr_fx["overlap"])
    vdir = os.path.join(workdir, "vr")
    os.makedirs(vdir, exist_ok=True)
    vpats = write_pan_flow(vdir, nv, face, face, tuple(int(v) for v in vr_fx["step"]),
                           faces=range(1, 7))
    vopt = VROptions(overlap_pixel_w=overlap, overlap_pixel_h=overlap,
                     **eval_options(vgg_path, style, *vpats))
    vev = evaluation.VREvaluator(vopt)
    geo = _Geometry(face, face, vopt)
    rows_vr = []
    for i, _, segs, prev, content in cases_vr:
        driver = types.SimpleNamespace(geo=geo, segments=list(segs),
                                       prev_segments=list(prev), last_content=content)
        rows_vr.append(vev(driver, i))
    return np.asarray(rows_2d, np.float64), np.asarray(rows_vr, np.float64)


FLOW_EVAL_SIZE, FLOW_EVAL_CASES = 192, 2


def _chip_smoke():
    """chip_smoke.py, which holds the trainer fixture's seeds, sizes and
    options (PARITY_*), its in-memory image source (ArraySource), its
    seeded images and parameter law (seeded_images, seeded_params) and
    flat_tree: phase 15 runs the port's side from the same code."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_train_run(vgg_path: str):
    """The JAX trainer's run of write_train: (losses, {key: first-iteration
    gradient L2 norm}, {key: final parameters})."""
    import copy

    import jax
    import jax.numpy as jnp
    from fast_artistic_videos_tpu.core.config import TrainOptions, schedule_value
    from fast_artistic_videos_tpu.models import registry
    from fast_artistic_videos_tpu.parallel import mesh as pmesh
    from fast_artistic_videos_tpu.train.trainer import Trainer
    from fast_artistic_videos_tpu.video.evaluation import load_vgg_params

    sm = _chip_smoke()
    flat_tree = sm.flat_tree
    opt = TrainOptions(style_image=registry.style_fixture("candy"), **sm.PARITY_OPTS)
    tr = Trainer(opt, vgg_params=load_vgg_params(vgg_path))
    tr.image_source = sm.ArraySource(sm.seeded_images(sm.PARITY_IMAGE_SEED, sm.PARITY_IMAGES,
                                                      sm.PARITY_HW), sm.PARITY_BATCH)
    shapes = {k: v.shape for k, v in flat_tree(jax.tree_util.tree_map(np.asarray,
                                                                      tr.params)).items()}
    params = jax.tree_util.tree_map(jnp.asarray,
                                    sm.seeded_params(sm.PARITY_PARAM_SEED, shapes))
    tr.params = jax.device_put(params, pmesh.replicated(tr.mesh))
    tr.opt_state = jax.device_put(tr.tx.init(tr.params), pmesh.replicated(tr.mesh))
    # the first iteration's gradient, from the batch the run draws first
    state = copy.deepcopy(tr.data_rng.bit_generator.state)
    cursor = dict(tr.image_source.cursor)
    source = tr._next_source()
    imgs, flows, certs, steps = tr._get_batch(
        "train", source, int(schedule_value(tr.frame_steps_sched, 1)))
    grads = jax.jit(jax.grad(lambda p: tr._loss_fn(
        p, imgs, flows, certs, jax.random.PRNGKey(0), steps, tr._first_mode(source))[0]))(
            tr.params)
    tr.data_rng.bit_generator.state = state
    tr.image_source.cursor = cursor
    tr.train(log_fn=lambda *a: None)
    norms = {k: float(np.linalg.norm(v)) for k, v in
             flat_tree(jax.tree_util.tree_map(np.asarray, grads)).items()}
    return (np.asarray(tr.train_loss_history, np.float64), norms,
            flat_tree(jax.tree_util.tree_map(np.asarray, tr.params)))


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def write_eval():
    demo, vr_fx = load(OUT), load(OUT_VR)
    with tempfile.TemporaryDirectory() as d:
        rows_2d, rows_vr = jax_eval_rows(demo, vr_fx, d, vgg_npz(EVAL_VGG_SEED,
                                                                 os.path.join(d, "vgg16.npz")))
    np.savez_compressed(OUT_EVAL, vgg_seed=np.int64(EVAL_VGG_SEED),
                        style_image_size=np.int64(EVAL_STYLE_SIZE),
                        rows_2d=rows_2d, rows_vr=rows_vr)
    print(f"wrote {OUT_EVAL} ({os.path.getsize(OUT_EVAL)} bytes)")


def write_train():
    with tempfile.TemporaryDirectory() as d:
        losses, norms, final = jax_train_run(vgg_npz(EVAL_VGG_SEED, os.path.join(d, "vgg16.npz")))
    out = {f"grad_norm/{k}": np.float64(v) for k, v in norms.items()}
    out.update({f"param_sum/{k}": np.float64(v.astype(np.float64).sum())
                for k, v in final.items()})
    out.update({f"param_abs/{k}": np.float64(np.abs(v.astype(np.float64)).sum())
                for k, v in final.items()})
    sm = _chip_smoke()
    np.savez_compressed(OUT_TRAIN, vgg_seed=np.int64(EVAL_VGG_SEED),
                        param_seed=np.int64(sm.PARITY_PARAM_SEED),
                        image_seed=np.int64(sm.PARITY_IMAGE_SEED), losses=losses, **out)
    print(f"wrote {OUT_TRAIN} ({os.path.getsize(OUT_TRAIN)} bytes)")


def write_flow_eval():
    from fast_artistic_videos_tpu.flow import estimator, train as flow_train

    res = flow_train.evaluate_heldout(estimator.load_params("bundled"), size=FLOW_EVAL_SIZE,
                                      n_cases=FLOW_EVAL_CASES)
    np.savez_compressed(OUT_FLOW_EVAL, size=np.int64(FLOW_EVAL_SIZE),
                        n_cases=np.int64(FLOW_EVAL_CASES), protocols=np.asarray(list(res)),
                        results=np.asarray([res[k] for k in res], np.float64))
    print(f"wrote {OUT_FLOW_EVAL} ({os.path.getsize(OUT_FLOW_EVAL)} bytes)")


def write_demo():
    frames = pan_frames(SEED, FRAMES, H, W)
    with tempfile.TemporaryDirectory() as d:
        outputs = run_jax_cli(frames, d)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, seed=np.int64(SEED), step=np.asarray(STEP),
                        frames=frames, outputs=outputs)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


def write_vr():
    faces = vr_faces()
    with tempfile.TemporaryDirectory() as d:
        outputs = run_jax_vr_cli(faces, d)
    os.makedirs(os.path.dirname(OUT_VR), exist_ok=True)
    np.savez_compressed(OUT_VR, seed=np.int64(VR_SEED), step=np.asarray(VR_STEP),
                        overlap=np.int64(VR_OVERLAP), faces=faces, outputs=outputs)
    print(f"wrote {OUT_VR} ({os.path.getsize(OUT_VR)} bytes)")


def write_batch():
    frames = pan_frames(BATCH_SEED, BATCH_FRAMES, BATCH_H, BATCH_W)
    out = {}
    for name, (extra, n) in BATCH_CASES.items():
        with tempfile.TemporaryDirectory() as d:
            out[f"outputs_{name}"] = run_jax_cli(frames[:n], d, extra)
        out[f"args_{name}"] = np.asarray(extra)
    os.makedirs(os.path.dirname(OUT_BATCH), exist_ok=True)
    np.savez_compressed(OUT_BATCH, seed=np.int64(BATCH_SEED), step=np.asarray(STEP),
                        frames=frames, **out)
    print(f"wrote {OUT_BATCH} ({os.path.getsize(OUT_BATCH)} bytes)")


def main():
    write_demo()
    write_vr()
    write_batch()
    write_eval()
    write_train()
    write_flow_eval()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
