"""The port's dataset makers (fast_artistic_videos_tpu_torch:
cli.make_image_dataset, cli.make_video_dataset) against the JAX package's
CLIs: the same seeded frames, .flo and .pgm files in, the HDF5 files
compared dataset by dataset (names, shapes, dtypes). Tolerance: uint8
frames and certainties within one step (a bilinear resize in torch and in
jax.image.resize can round to either side of a .5), float32 flows 1e-5 of
their largest value; at the stored size (no resize) everything exactly.
The port's train.data sources read what the port wrote.

The JAX CLI's make_video_dataset fails when it resizes: its _resize hands
back jax.image.resize's read-only numpy view, which the flow rescale then
writes into (make_video_dataset.py:67). The test wraps that _resize in a
copy (the same values) for the resized cases; the JAX package is left as
it is."""

import os

import h5py
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.cli import make_image_dataset as jimg
from fast_artistic_videos_tpu.cli import make_video_dataset as jvid
from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu_torch.cli import make_image_dataset as timg
from fast_artistic_videos_tpu_torch.cli import make_video_dataset as tvid
from fast_artistic_videos_tpu_torch.train import data as tdata

H, W = 30, 40


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Three scenes of 5 seeded frames (H, W), each with flow files
    (random fields), certainty .pgm files and two sequence markers."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(70)
    for s in range(3):
        d = root / f"scene{s}"
        (d / "flow").mkdir(parents=True)
        for i in range(1, 6):
            io.save_image(str(d / f"frame_{i:05d}.ppm"), rng.random((H, W, 3)))
        for i in range(1, 5):
            prefix = "s_" if i in (1, 3) else ""
            io.write_flo(str(d / "flow" / f"{prefix}{i}_{i + 1}.flo"),
                         rng.normal(0, 3, (H, W, 2)).astype(np.float32))
            io.write_pgm(str(d / "flow" / f"reliable_{prefix}{i}_{i + 1}.pgm"),
                         rng.integers(0, 256, (H, W), dtype=np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(71)
    for i in range(7):
        ext = (".png", ".ppm")[i % 2]
        io.save_image(str(root / f"img{i}{ext}"), rng.random((H + i, W - i, 3)))
    return str(root)


def _compare(got_path, want_path):
    with h5py.File(got_path) as g, h5py.File(want_path) as w:
        names = []
        w.visit(names.append)
        got_names = []
        g.visit(got_names.append)
        assert sorted(got_names) == sorted(names)
        for name in names:
            if not isinstance(w[name], h5py.Dataset):
                continue
            a, b = g[name][()], w[name][()]
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if a.dtype == np.uint8:
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                           err_msg=name)


@pytest.mark.parametrize("size", [(H, W), (24, 36), (48, 56)])
def test_make_video_dataset_matches_jax(scenes, tmp_path, monkeypatch, size):
    """At the stored size, shrunk and grown (flows rescaled), sequences of
    3 frames, train/val split from the seed."""
    resize = jvid._resize
    monkeypatch.setattr(jvid, "_resize", lambda img, h, w: np.array(resize(img, h, w)))
    args = ["--input_dir", scenes, "--height", str(size[0]), "--width", str(size[1]),
            "--sequence_length", "3", "--val_fraction", "0.34", "--seed", "5"]
    want, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jvid.main(args + ["--output_file", want]) == 0
    assert tvid.main(args + ["--output_file", got, "--device", "cpu"]) == 0
    _compare(got, want)
    if size == (H, W):
        with h5py.File(got) as g, h5py.File(want) as w:
            for name in ("train/frames1", "train/flow", "train/cert"):
                np.testing.assert_array_equal(g[name][()], w[name][()])
    src = tdata.H5VideoSource(got, 2)
    try:
        imgs, flows, certs = src.get_batch("train", 2)
        assert imgs[0].shape == (2,) + size + (3,) and flows[1].shape == (2,) + size + (2,)
    finally:
        src.close()


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_make_image_dataset_matches_jax(image_dir, tmp_path, size):
    args = ["--input_dir", image_dir, "--height", str(size[0]), "--width", str(size[1]),
            "--val_fraction", "0.3", "--seed", "2", "--max_images", "6"]
    want, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jimg.main(args + ["--output_file", want]) == 0
    assert timg.main(args + ["--output_file", got, "--device", "cpu"]) == 0
    _compare(got, want)
    src = tdata.H5ImageSource(got, 2)
    try:
        assert src.next_images("train").shape == (2,) + size + (3,)
    finally:
        src.close()
    assert os.path.getsize(got) > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only host's refusal")
@pytest.mark.parametrize("cli", ["image", "video"])
def test_dataset_clis_default_to_the_card(cli, image_dir, scenes, tmp_path):
    """Without --device both CLIs resize on the card, and raise where there
    is none rather than fall back to the CPU."""
    mod, src = (timg, image_dir) if cli == "image" else (tvid, scenes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--input_dir", src, "--output_file", str(tmp_path / "x.h5")])
