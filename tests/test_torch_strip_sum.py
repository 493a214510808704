"""K5's summing entry on the CPU: ``ops.strip_warp_kernel.StripSet``, which
computes each VR border prior and each frame's cross-face blend in one
launch on a card, through its plain version here.

The plain version is held against the composition the port's VR driver ran
before (one single-map warp per term, rotated copies, torch adds and
divides, written out below), and against the JAX driver's border prior and
blend over the Pallas strip warp it replaces (interpret mode, as
tests/test_warp_pallas.py runs it), at 48-px faces with a 16-px overlap:
float32 1e-5. The rotation that the kernel folds into its source index
(``strip_warp_kernel.rotated_source``) is held against
``video/vr_geometry``'s rotations, and through ``StripWarp.plain(img,
rot)`` against the warp of the rotated copy, for every map and rotation.
The kernel's own arithmetic is held against this plain version on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.video import driver_vr as jdrv
from fast_artistic_videos_tpu_torch.ops import strip_warp_kernel as swk
from fast_artistic_videos_tpu_torch.video import driver_vr as tdrv
from fast_artistic_videos_tpu_torch.video import vr_geometry as tvr

FACE, OVERLAP = 48, 16
MAPS = ("left", "right", "top", "bottom")
ROTATE = {0: lambda x: x, swk.R90: tvr.rotate90, swk.RM90: tvr.rotate_minus90,
          swk.R180: tvr.rotate180}
CASES = [1, 2, 3, 4, 5, "blend"]


def _faces(seed):
    rng = np.random.default_rng(seed)
    return [rng.random((FACE, FACE, 3)).astype(np.float32) for _ in range(6)]


def _done(faces, pos):
    """The driver's segments[:4] at processing position pos: the faces
    already stylized, None for the others."""
    return [faces[i] if i < pos else None for i in range(4)]


@pytest.fixture(scope="module")
def geo():
    opt = tdrv.VROptions(overlap_pixel_w=OVERLAP, overlap_pixel_h=OVERLAP)
    g = tdrv._Geometry(FACE, FACE, opt, "cpu")
    assert isinstance(g.borders, swk.StripSet)
    return g


def _todays_prior(g, pos, segments):
    """The port driver's border prior before the summing entry."""
    zero = torch.zeros((g.hplus, g.wplus, 3))
    s0, s1, s2, s3 = [s if s is not None else zero for s in segments]
    wl, wr, wt, wb = g.warp_left, g.warp_right, g.warp_top, g.warp_bottom
    div = g.mask_all_div[..., None]
    r90, rm90, r180 = tvr.rotate90, tvr.rotate_minus90, tvr.rotate180
    if pos == 1:
        return wl(s0)
    if pos == 2:
        return wr(s0)
    if pos == 3:
        return wl(s1) + wr(s2)
    if pos == 4:
        return (wl(r90(s1)) / div + wr(rm90(s2)) / div
                + wt(s3) / div + wb(r180(s0)) / div)
    return (wl(rm90(s1)) / div + wr(r90(s2)) / div
            + wt(r180(s0)) / div + wb(s3) / div)


def _todays_blend(g, s):
    """The port driver's cross-face blend before the summing entry."""
    gm = g.grad_all[..., None]
    div = g.mask_all_div[..., None]
    wl, wr, wt, wb = g.warp_left, g.warp_right, g.warp_top, g.warp_bottom
    r90, rm90, r180 = tvr.rotate90, tvr.rotate_minus90, tvr.rotate180

    def combine(a, b, c, d):
        return (a + b + c + d) / div

    borders = [
        combine(wr(s[1]), wl(s[2]), wb(r180(s[4])), wt(r180(s[5]))),
        combine(wl(s[0]), wr(s[3]), wb(rm90(s[4])), wt(r90(s[5]))),
        combine(wr(s[0]), wl(s[3]), wb(r90(s[4])), wt(rm90(s[5]))),
        combine(wl(s[1]), wr(s[2]), wb(s[4]), wt(s[5])),
        combine(wb(r180(s[0])), wl(r90(s[1])), wr(rm90(s[2])), wt(s[3])),
        combine(wt(r180(s[0])), wl(rm90(s[1])), wr(r90(s[2])), wb(s[3])),
    ]
    return [s[p] * (1 - gm) + borders[p] * gm for p in range(6)]


def _port(g, case, faces):
    """StripSet's result for `case` (a prior position or the blend), as
    numpy arrays."""
    t = [torch.from_numpy(f) if f is not None else None for f in faces]
    if case == "blend":
        return [x.numpy() for x in g.borders.blend(t, g.grad_all, g.mask_all_div)]
    return [g.borders.prior(case, t[:4], g.mask_all_div).numpy()]


@pytest.mark.parametrize("case", CASES)
def test_strip_set_matches_todays_composition(geo, case):
    faces = _faces(0)
    if case == "blend":
        got = _port(geo, case, faces)
        want = _todays_blend(geo, [torch.from_numpy(f) for f in faces])
    else:
        done = _done(faces, case)
        got = _port(geo, case, done)
        want = [_todays_prior(geo, case, [torch.from_numpy(f) if f is not None else None
                                          for f in done])]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == (FACE, FACE, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_driver():
    """The JAX VR driver with the Pallas strip warps (interpret mode on the
    CPU); only its geometry, border builders and blend are used."""
    opt = jdrv.VROptions(overlap_pixel_w=OVERLAP, overlap_pixel_h=OVERLAP,
                         pallas_strip_warp=True)
    d = jdrv.VRDriver(None, opt)
    d.geo = jdrv._Geometry(FACE, FACE, opt)
    return d


@pytest.mark.parametrize("case", CASES)
def test_strip_set_matches_jax_driver(geo, jax_driver, case):
    faces = _faces(1)
    if case == "blend":
        jax_driver.segments = list(faces)
        want = [np.asarray(x) for x in jax_driver.blend_other_sides()]
        got = _port(geo, case, faces)
    else:
        done = _done(faces, case)
        zero = np.zeros((FACE, FACE, 3), np.float32)
        args = [jnp.asarray(x if x is not None else zero) for x in done]
        want = [np.asarray(jax_driver._border_fn(case)(*args))]
        got = _port(geo, case, done)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rot", sorted(ROTATE))
def test_rotated_source_is_the_rotation(rot):
    """The kernel's index map of a rotated pixel, on a non-square image:
    gathering the source at rotated_source(rot, r, c) gives rotate(img)."""
    img = torch.from_numpy(np.random.default_rng(2).random((7, 11, 3)))
    want = ROTATE[rot](img)
    r, c = torch.meshgrid(torch.arange(want.shape[0]), torch.arange(want.shape[1]),
                          indexing="ij")
    sr, sc = swk.rotated_source(rot, r, c, 7, 11)
    assert torch.equal(img[sr, sc], want)


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("rot", sorted(ROTATE))
def test_rotation_folded_into_the_taps(name, rot):
    """The strip warp with the rotation folded into its source index (the
    summing entry's taps) equals the warp of the rotated copy, on every
    border map."""
    m = getattr(tvr, f"perspective_warp_map_{name}")(FACE, OVERLAP, FACE)
    fn = swk.make_static_strip_warp(m)
    img = torch.from_numpy(np.random.default_rng(3).random((FACE, FACE, 3)).astype(np.float32))
    np.testing.assert_allclose(fn.plain(img, rot).numpy(), fn.plain(ROTATE[rot](img)).numpy(),
                               rtol=0, atol=1e-6)
