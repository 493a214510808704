"""The port's training data sources (fast_artistic_videos_tpu_torch:
train.data, train.data_vr, ops.tv) against the JAX package's, on the same
seeded numpy images and the same np.random.Generator seed. Tolerance: 1e-5
of each array's largest value (the resizes run in torch and in
jax.image.resize, the preprocessing in float32 on both sides); flows,
certainties, shard ranges and cursors exactly. tv_loss and its gradient:
1e-5 relative."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.ops import tv as jtv
from fast_artistic_videos_tpu.train import data as jdata
from fast_artistic_videos_tpu.train import data_vr as jdata_vr
from fast_artistic_videos_tpu_torch.ops import tv as ttv
from fast_artistic_videos_tpu_torch.train import data as tdata
from fast_artistic_videos_tpu_torch.train import data_vr as tdata_vr

TOL = 1e-5


def _close(got, want, exact=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0))


def _batches_close(got, want):
    """(imgs, flows, certs) of the two packages: images to TOL, flows and
    certainties exactly (both are built from the same integers)."""
    for g_list, w_list, exact in zip(got, want, (False, True, False)):
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            _close(g, w, exact)


def _images(seed, n=2, h=40, w=48):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("source,num_steps,seed", [
    ("shift", 1, 3), ("shift", 3, 4), ("zoom_out", 1, 5), ("zoom_out", 2, 6),
    ("single_image", 1, 7),
])
def test_synthetic_batches_match_jax(source, num_steps, seed):
    """One rng seed draws the same batch in both packages, and leaves both
    generators in the same state."""
    images = _images(seed)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jdata.SYNTHETIC_SOURCES[source](images, num_steps, rj)
    got = tdata.SYNTHETIC_SOURCES[source](images, num_steps, rt)
    _batches_close(got, want)
    assert rj.integers(1 << 30) == rt.integers(1 << 30)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vr_batch_matches_jax(seed):
    """The vr source (the rng picks each of the four sides over these
    seeds) at the reference's 256 px, from 96 px images (resized to the
    384 px geometry and back down to 256)."""
    images = _images(10 + seed, n=2, h=96, w=96)
    want = jdata_vr.vr_batch(images, np.random.default_rng(seed), (256, 256))
    got = tdata_vr.vr_batch(images, np.random.default_rng(seed), (256, 256),
                            tdata_vr.VRMaps())
    _batches_close(got, want)
    assert 64 in got[0][0].shape[1:3] and 0.0 < got[2][0].mean() < 0.9


def test_vr_batch_rejects_small_sizes():
    with pytest.raises(ValueError):
        tdata_vr.vr_batch(_images(0, h=96, w=96), np.random.default_rng(0), (64, 64))


@pytest.mark.parametrize("n,shards", [(10, 1), (10, 3), (7, 4), (1, 2)])
def test_shard_range_matches_jax(n, shards):
    for i in range(shards):
        assert tdata.shard_range(n, shards, i) == jdata.shard_range(n, shards, i)
    with pytest.raises(ValueError):
        tdata.shard_range(n, shards, shards)


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(20)
    coco, video = str(d / "coco.h5"), str(d / "video.h5")
    with h5py.File(coco, "w") as f:
        for split, n in (("train2014", 7), ("val2014", 5)):
            f.create_dataset(f"/{split}/images",
                             data=rng.integers(0, 256, (n, 3, 36, 44), dtype=np.uint8))
    with h5py.File(video, "w") as f:
        for split in ("train", "val"):
            f.create_dataset(f"/{split}/frames1",
                             data=rng.integers(0, 256, (5, 4, 3, 24, 32), dtype=np.uint8))
            f.create_dataset(f"/{split}/flow",
                             data=rng.normal(size=(5, 3, 2, 24, 32)).astype(np.float32))
            f.create_dataset(f"/{split}/cert",
                             data=rng.integers(0, 256, (5, 3, 24, 32), dtype=np.uint8))
    return coco, video


@pytest.mark.parametrize("out_hw,shards", [(None, 1), ((32, 32), 1), ((48, 40), 2)])
def test_h5_image_source_matches_jax(h5_files, out_hw, shards):
    """Batches, cursor wrap and reset, per shard; out_hw shrinks (32x32,
    antialiased) or grows (48x40) the stored 36x44 images."""
    for idx in range(shards):
        kw = dict(out_hw=out_hw, max_train=6, num_shards=shards, shard_index=idx)
        js = jdata.H5ImageSource(h5_files[0], 2, **kw)
        ts = tdata.H5ImageSource(h5_files[0], 2, **kw)
        try:
            assert ts.ranges == js.ranges
            for split in ("train", "val", "train", "train", "val"):
                _close(ts.next_images(split), js.next_images(split))
                assert ts.cursor == js.cursor
            ts.reset("train")
            js.reset("train")
            assert ts.cursor == js.cursor
        finally:
            ts.close()


def test_h5_video_source_matches_jax(h5_files):
    js = jdata.H5VideoSource(h5_files[1], 2)
    ts = tdata.H5VideoSource(h5_files[1], 2)
    try:
        for split, steps in (("train", 1), ("train", 3), ("val", 2), ("train", 2)):
            _batches_close(ts.get_batch(split, steps), js.get_batch(split, steps))
            assert ts.cursor == js.cursor
        for it in (1, 4, 9):
            js.set_cursor_from_iteration("train", it)
            ts.set_cursor_from_iteration("train", it)
            assert ts.cursor == js.cursor
        with pytest.raises(ValueError):
            ts.get_batch("train", 4)
    finally:
        ts.close()


@pytest.mark.parametrize("shape,strength", [((2, 9, 11, 3), 1.0), ((13, 7, 3), 1e-6)])
def test_tv_loss_and_gradient_match_jax(shape, strength):
    x = np.random.default_rng(30).normal(size=shape).astype(np.float32) * 50
    want, gwant = jax.value_and_grad(lambda a: jtv.tv_loss(a, strength))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ttv.tv_loss(xt, strength)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=0,
                               atol=TOL * np.abs(np.asarray(gwant)).max())
