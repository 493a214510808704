"""The port's StylizerEngine (stylize_first / stylize_next) against the JAX
package's engine on the bundled demo model, float32 max-abs 1e-3: odd frame
sizes (stride padding), uint8 content, the banded and exact warps, the
pre-eroded certainty and the fused uint8 output. The uniform-random
occlusion fill draws from a torch.Generator, so it is checked by its mask
and its statistics, not its values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.ops import filters as jfilters
from fast_artistic_videos_tpu.video import engine as jeng
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import filters as tfilters
from fast_artistic_videos_tpu_torch.ops.preprocess import VGG_MEAN_BGR
from fast_artistic_videos_tpu_torch.video import engine as teng
from tests.test_torch_stylizer import numpy_params, parse_both


@pytest.fixture(scope="module")
def engines():
    spec, pj, _ = jckpt.load_model("demo")
    tspec, pt, _ = tckpt.load_model("demo", device="cpu")
    je = jeng.StylizerEngine(lambda p, x: jsty.apply(p, spec, x), pj,
                             stride_multiple=spec.total_stride)
    te = teng.StylizerEngine(lambda p, x: tsty.apply(p, tspec, x), pt,
                             stride_multiple=tspec.total_stride, device="cpu")
    return je, te


def _inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    content = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    prev = rng.random((h, w, 3), dtype=np.float32)
    flow = np.stack([np.full((h, w), 2.6), np.full((h, w), -1.3)], -1).astype(np.float32)
    flow += rng.standard_normal((h, w, 2)).astype(np.float32) * 0.3
    cert = (rng.random((h, w)) > 0.2).astype(np.float32)
    return content, prev, flow, cert


def test_stylize_first_matches_jax(engines):
    je, te = engines
    content, _, _, _ = _inputs(0, 50, 70)           # not a multiple of 4
    want, want_u8 = je.stylize_first(content, emit_u8=True)
    got, got_u8 = te.stylize_first(content, emit_u8=True)
    assert tuple(got.shape) == (50, 70, 3) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
    assert np.abs(got_u8.numpy().astype(int) - np.asarray(want_u8)).max() <= 1


@pytest.mark.parametrize("band_hint,pre_eroded,exact", [
    (None, False, False), (8, False, False), (8, True, False), (None, False, True)])
def test_stylize_next_matches_jax(engines, band_hint, pre_eroded, exact):
    je, te = engines
    je.config.exact_warp = te.config.exact_warp = exact
    try:
        content, prev, flow, cert = _inputs(1, 49, 70)
        want = je.stylize_next(content, prev, flow, cert, band_hint,
                               pre_eroded=pre_eroded)
        got = te.stylize_next(content, prev, flow, cert, band_hint,
                              pre_eroded=pre_eroded)
    finally:
        je.config.exact_warp = te.config.exact_warp = False
    assert tuple(got.shape) == (49, 70, 3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3


def test_recurrence_on_device_tensors(engines):
    """The carry is the tensor the previous step returned; float content."""
    je, te = engines
    content, _, flow, cert = _inputs(2, 50, 70)
    c2 = content.astype(np.float32) / 255.0
    jy = je.stylize_first(content)
    ty = te.stylize_first(content)
    jy, ju8 = je.stylize_next(c2, jy, flow, cert, 8, emit_u8=True)
    ty, tu8 = te.stylize_next(torch.from_numpy(c2), ty, torch.from_numpy(flow),
                              torch.from_numpy(cert), 8, emit_u8=True)
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-3
    assert tu8.dtype == torch.uint8
    assert np.abs(tu8.numpy().astype(int) - np.asarray(ju8)).max() <= 1


def test_image_model_first_frame_matches_jax():
    """--model_img: frame 1 goes through a separate 3-channel image model."""
    spec_v, pj, _ = jckpt.load_model("demo")
    tspec_v, pt, _ = tckpt.load_model("demo", device="cpu")
    spec_i, tspec_i = parse_both("c9s1-8,d16,R16,u8,c9s1-3", in_channels=3)
    pij = numpy_params(spec_i, 8)
    pit = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pij), device="cpu")
    je = jeng.StylizerEngine(lambda p, x: jsty.apply(p, spec_v, x), pj,
                             lambda p, x: jsty.apply(p, spec_i, x), pij)
    te = teng.StylizerEngine(lambda p, x: tsty.apply(p, tspec_v, x), pt,
                             lambda p, x: tsty.apply(p, tspec_i, x), pit, device="cpu")
    content, _, _, _ = _inputs(7, 48, 64)
    want = je.stylize_first(content)
    got = te.stylize_first(content)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3


def test_min_filter_matches_jax():
    x = np.random.default_rng(3).random((2, 23, 31), dtype=np.float32)
    for size in (1, 3, 7):
        want = np.asarray(jfilters.min_filter(jnp.asarray(x[0]), size))
        got = tfilters.min_filter(torch.from_numpy(x[0]), size).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jfilters.min_filter(jnp.asarray(x[..., None]), 5))
    np.testing.assert_array_equal(tfilters.min_filter(torch.from_numpy(x[..., None]), 5).numpy(),
                                  want)


def test_uniform_random_fill_mask_and_statistics():
    spec, pt, _ = tckpt.load_model("demo", device="cpu")
    cfg = teng.EngineConfig(fill_occlusions="uniform-random", seed=5)
    te = teng.StylizerEngine(lambda p, x: tsty.apply(p, spec, x), pt, config=cfg,
                             device="cpu")
    content, prev, _, _ = _inputs(4, 120, 160)
    cert = np.zeros((120, 160), np.float32)
    cert[:, :80] = 1.0
    x = te._assemble(torch.from_numpy(content), torch.from_numpy(prev),
                     torch.from_numpy(cert))[0].numpy()
    prior = x[..., 3:6]
    want_kept = prev[..., ::-1] * 255.0 - np.asarray(VGG_MEAN_BGR, np.float32)
    np.testing.assert_allclose(prior[:, :80], want_kept[:, :80], atol=1e-3)
    noise = prior[:, 80:] + np.asarray(VGG_MEAN_BGR, np.float32)   # U(0, 255)
    assert noise.min() >= 0.0 and noise.max() <= 255.0
    assert abs(noise.mean() - 127.5) < 3.0
    assert abs(noise.std() - 255.0 / np.sqrt(12.0)) < 3.0
    np.testing.assert_array_equal(x[..., 6], cert)
    # the generator is seeded by EngineConfig.seed: same seed, same fill
    te2 = teng.StylizerEngine(lambda p, x: tsty.apply(p, spec, x), pt, config=cfg,
                             device="cpu")
    x2 = te2._assemble(torch.from_numpy(content), torch.from_numpy(prev),
                       torch.from_numpy(cert))[0].numpy()
    np.testing.assert_array_equal(x, x2)
    out = te.stylize_first(content)
    assert tuple(out.shape) == (120, 160, 3) and torch.isfinite(out).all()
