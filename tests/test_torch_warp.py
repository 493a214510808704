"""The port's flow warp (fast_artistic_videos_tpu_torch.ops.warp, kernel K1's
plain version on the CPU) against the JAX package's ops.warp and the Pallas
banded warp in interpret mode. Inputs are made with numpy from a seed and
go through both packages; float32 results agree to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.ops import warp as jwarp
from fast_artistic_videos_tpu.ops import warp_pallas
from fast_artistic_videos_tpu_torch.ops import warp as twarp
from fast_artistic_videos_tpu_torch.ops import warp_kernel


def _inputs(seed, shape, band, spread=1.0):
    """Image in [0, 1] and a smooth-ish flow reaching `spread` x band, so
    some taps fall outside the band and outside the image."""
    rng = np.random.default_rng(seed)
    img = rng.random(shape, dtype=np.float32)
    fshape = shape[:-1] + (2,)
    flow = (rng.random(fshape, dtype=np.float32) * 2 - 1) * band * spread
    return img, flow.astype(np.float32)


@pytest.mark.parametrize("shape,band,spread", [
    ((23, 37, 2), 8, 1.3),
    ((31, 29, 3), 8, 1.0),
    ((17, 45, 32), 16, 1.4),
    ((3, 21, 33, 3), 8, 1.2),      # batched
])
def test_banded_warp_matches_jax(shape, band, spread):
    img, flow = _inputs(1, shape, band, spread)
    got = twarp.bilinear_warp(torch.from_numpy(img), torch.from_numpy(flow), band=band)
    want = np.asarray(jwarp.bilinear_warp(jnp.asarray(img), jnp.asarray(flow), band=band))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape,band", [((19, 27, 3), 8), ((16, 24, 2), 16),
                                        ((2, 13, 19, 32), 8)])
def test_banded_warp_matches_pallas_interpret(shape, band):
    img, flow = _inputs(2, shape, band, 1.3)
    got = twarp.bilinear_warp(torch.from_numpy(img), torch.from_numpy(flow), band=band)
    want = np.asarray(warp_pallas.bilinear_warp_pallas(
        jnp.asarray(img), jnp.asarray(flow), band, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_banded_warp_bf16_input():
    img, flow = _inputs(3, (21, 35, 3), 8, 1.1)
    tb = torch.from_numpy(img).to(torch.bfloat16)
    got = twarp.bilinear_warp(tb, torch.from_numpy(flow), band=8)
    assert got.dtype == torch.bfloat16
    jb = jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jwarp.bilinear_warp(jb, jnp.asarray(flow), band=8), np.float32)
    # same float32 math on the same bf16 inputs; the result rounds to bf16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", [(15, 22, 3), (2, 11, 17, 2)])
def test_exact_gather_matches_jax(shape):
    img, flow = _inputs(4, shape, 6, 1.5)
    got = twarp.bilinear_warp(torch.from_numpy(img), torch.from_numpy(flow))
    want = np.asarray(jwarp.bilinear_warp(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_flow_band_buckets_match_jax():
    for v in [0.0, 3.5, 8.0, 8.01, 23.9, 63.0, 64.5, 100.0, 300.0]:
        assert twarp.flow_band(v) == jwarp.flow_band(v)


def test_wrapper_rejects_bad_device_input():
    img = torch.zeros(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError):
        warp_kernel.warp_banded(img, torch.zeros(1, 4, 4, 2, device="meta"), 8)

