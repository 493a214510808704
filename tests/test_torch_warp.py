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
    # the main path's channel counts: the consistency sample and the fast
    # check (2), frames (3), the flow pyramid's feature warps (16, 64), the
    # reuse delta warp (128), the VR path's six faces batched; flows past
    # the band and past these small images
    ((1, 19, 26, 2), 8, 2.5),
    ((6, 13, 17, 3), 8, 1.6),
    ((6, 11, 15, 16), 8, 1.5),
    ((1, 14, 19, 64), 16, 1.4),
    ((1, 12, 23, 128), 8, 2.0),
])
def test_banded_warp_matches_jax(shape, band, spread):
    img, flow = _inputs(1, shape, band, spread)
    got = twarp.bilinear_warp(torch.from_numpy(img), torch.from_numpy(flow), band=band)
    want = np.asarray(jwarp.bilinear_warp(jnp.asarray(img), jnp.asarray(flow), band=band))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape,band", [((19, 27, 3), 8), ((16, 24, 2), 16),
                                        ((2, 13, 19, 32), 8),
                                        ((6, 11, 17, 16), 8), ((1, 9, 12, 64), 8),
                                        ((1, 13, 19, 128), 8), ((6, 12, 21, 2), 8)])
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


@pytest.mark.parametrize("shape,band", [((1, 19, 26, 2), 8), ((6, 13, 17, 3), 8),
                                        ((6, 11, 15, 16), 8), ((1, 14, 19, 64), 16),
                                        ((1, 12, 23, 128), 8)])
def test_banded_warp_bf16_matches_jax(shape, band):
    """bfloat16 images at the main path's channel counts, flows past the
    band and the image: the same float32 math on the same bf16 values as
    the JAX package, one rounding to bf16 at the end."""
    img, flow = _inputs(5, shape, band, 1.6)
    tb = torch.from_numpy(img).to(torch.bfloat16)
    got = twarp.bilinear_warp(tb, torch.from_numpy(flow), band=band)
    assert got.dtype == torch.bfloat16
    jb = jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jwarp.bilinear_warp(jb, jnp.asarray(flow), band=band), np.float32)
    # one bf16 rounding apart at most: float32 sums in another order can
    # round to the neighbouring bf16 value
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8, rtol=0)


F32, BF16 = torch.float32, torch.bfloat16
PIXEL, VEC = warp_kernel.PIXEL_ENTRY, warp_kernel.VEC_ENTRY


@pytest.mark.parametrize("c,dtype,aligned,want", [
    (2, F32, True, (PIXEL, 2)),       # flow: the consistency sample, the fast check
    (3, F32, True, (PIXEL, 3)),       # frames: the prior and VR temporal warps
    (3, BF16, True, (PIXEL, 3)),
    (2, BF16, True, (PIXEL, 2)),
    (4, BF16, True, (PIXEL, 4)),      # 8 bytes: under one 16-byte vector
    (1, F32, True, (PIXEL, 1)),
    (4, F32, True, (VEC, 4)),         # one 16-byte vector a pixel
    (16, F32, True, (VEC, 4)),        # the flow pyramid's feature warps
    (32, F32, True, (VEC, 4)),
    (64, F32, True, (VEC, 4)),
    (96, F32, True, (VEC, 4)),
    (128, F32, True, (VEC, 4)),       # the reuse delta warp
    (16, BF16, True, (VEC, 8)),
    (32, BF16, True, (VEC, 8)),
    (64, BF16, True, (VEC, 8)),
    (128, BF16, True, (VEC, 8)),
    (5, F32, True, (VEC, 1)),         # the scalar path
    (6, F32, True, (VEC, 1)),
    (12, BF16, True, (VEC, 1)),       # not a multiple of 8 bf16
    (5, BF16, True, (VEC, 1)),
    (16, F32, False, (VEC, 1)),       # an image off a 16-byte boundary
    (64, BF16, False, (VEC, 1)),
    (4, F32, False, (PIXEL, 4)),
    (3, F32, False, (PIXEL, 3)),
])
def test_warp_route(c, dtype, aligned, want):
    assert warp_kernel.warp_route(c, dtype, aligned) == want


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

