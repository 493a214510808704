"""The port's flow stack (fast_artistic_videos_tpu_torch.flow: estimator,
consistency check, streaming provider) against the JAX package's, on the
bundled estimator weights and seeded synthetic pans. Flows agree within
1e-3 px (float32); the thresholded masks agree on at least 99.5 % of the
pixels and the band-sizing signal within rtol 1e-4; the provider picks the
same warp bands."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.flow import consistency as jcons
from fast_artistic_videos_tpu.flow import estimator as jest
from fast_artistic_videos_tpu.flow import provider as jprov
from fast_artistic_videos_tpu_torch.flow import consistency as tcons
from fast_artistic_videos_tpu_torch.flow import estimator as test_
from fast_artistic_videos_tpu_torch.flow import provider as tprov

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pan(seed, n, h, w, step):
    path = os.path.join(ROOT, "tools", "make_torch_parity_fixture.py")
    spec = importlib.util.spec_from_file_location("make_torch_parity_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pan_frames(seed, n, h, w, step)


@pytest.fixture(scope="module")
def estimators():
    jp = jest.load_params("bundled")
    return jest.FlowEstimator(jp), test_.FlowEstimator(test_.load_params("bundled", device="cpu"), device="cpu")


# the provider's form first (its compile is shared with the provider test);
# fast_check takes precedence over coarse_backward, so they get a case each
# (coarse_backward's is at full scale, below)
@pytest.mark.parametrize("kw", [dict(with_lowres=True),
                                dict(with_lowres=True, fast_check=True)])
def test_refine_pair_matches_jax(estimators, kw):
    je, te = estimators
    a, b = _pan(1, 2, 64, 96, (3, 2))
    hw = (64, 96)
    want = je.refine_pair(je.prep(jnp.asarray(a), 0.5), je.prep(jnp.asarray(b), 0.5),
                          hw, 0.5, **kw)
    got = te.refine_pair(te.prep(torch.from_numpy(a), 0.5),
                         te.prep(torch.from_numpy(b), 0.5), hw, 0.5, **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-3


def test_full_scale_flow_matches_jax(estimators):
    """flow_scale 1 (no resize), both directions at full resolution, the
    cross-check direction one pyramid level coarser."""
    je, te = estimators
    a, b = _pan(2, 2, 48, 64, (1, 2))
    want = je.refine_pair(je.prep(jnp.asarray(a)), je.prep(jnp.asarray(b)), (48, 64),
                          coarse_backward=True)
    got = te.refine_pair(te.prep(torch.from_numpy(a)), te.prep(torch.from_numpy(b)), (48, 64),
                         coarse_backward=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-3


@pytest.mark.parametrize("src,dst", [((37, 53), (18, 27)), ((64, 96), (32, 48)),
                                     ((30, 41), (61, 83)), ((20, 30), (40, 60))])
def test_bilinear_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).random(src + (3,), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (3,), "bilinear"))
    got = test_.resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _flows(seed, h, w, mag):
    """A smooth flow pair with a discontinuity (so masks are not trivial)."""
    rng = np.random.default_rng(seed)
    f1 = np.zeros((h, w, 2), np.float32)
    f1[..., 0] = mag + rng.random((h, w)) * 0.2
    f1[..., 1] = -mag / 2 + rng.random((h, w)) * 0.2
    f1[h // 3:h // 2, w // 4:w // 2] *= -1.5
    f2 = -f1 + rng.standard_normal((h, w, 2)).astype(np.float32) * 0.3
    img = rng.random((h, w, 3), dtype=np.float32)
    return f1, f2, img


@pytest.mark.parametrize("band", [None, 8])
def test_consistency_mask_matches_jax(band):
    f1, f2, img = _flows(4, 40, 56, 3.0)
    want, wmax = jcons.consistency_mask(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(img),
                                        band=band, warp_limit=4.0, with_rel_maxabs=True)
    got, gmax = tcons.consistency_mask(torch.from_numpy(f1), torch.from_numpy(f2),
                                       torch.from_numpy(img), band=band, warp_limit=4.0,
                                       with_rel_maxabs=True)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995
    np.testing.assert_allclose(float(gmax), float(wmax), rtol=1e-4)


@pytest.mark.parametrize("out_hw,erode", [((80, 112), 7), ((80, 112), None),
                                          ((83, 117), 5), ((40, 56), 7)])
def test_consistency_streaming_matches_jax(out_hw, erode):
    f1, f2, _ = _flows(5, 40, 56, 2.5)
    img = (np.random.default_rng(5).random(out_hw + (3,)) * 255).astype(np.uint8)
    want, wmax = jcons.consistency_mask_streaming(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(img), out_hw=out_hw, band=16,
        erode_window=erode, warp_limit=3.0, with_rel_maxabs=True)
    got, gmax = tcons.consistency_mask_streaming(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(img), out_hw=out_hw,
        band=16, erode_window=erode, warp_limit=3.0, with_rel_maxabs=True)
    assert tuple(got.shape) == out_hw
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995
    np.testing.assert_allclose(float(gmax), float(wmax), rtol=1e-4)


@pytest.mark.parametrize("step", [(3, 2), (-11, 5)])
def test_provider_bands_match_jax(estimators, step):
    je, te = estimators
    frames = _pan(6, 4, 64, 96, step)
    jp = jprov.StreamingFlowProvider(flow_estimator=je, flow_scale=0.5, erode_window=7)
    tp = tprov.StreamingFlowProvider(flow_estimator=te, flow_scale=0.5, erode_window=7)
    for t, f in enumerate(frames):
        want = jp(jnp.asarray(f))
        got = tp(torch.from_numpy(f))
        if t == 0:
            assert want is None and got is None
            continue
        assert tp.last_band == jp.last_band
        assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 1e-3
        assert (got[1].numpy() == np.asarray(want[1])).mean() >= 0.995
