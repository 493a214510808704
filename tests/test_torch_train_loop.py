"""The port's style trainer on its own (fast_artistic_videos_tpu_torch:
train.trainer, cli.train), on the CPU with the JAX tests' small
architecture at 32 px: gradients through the last unrolled step only, the
loss decreasing, every data source and a style image, the vr source,
bit-identical port-against-port resume (the JAX package's PRNG cannot be
reproduced, so resume is not held against it), the CLI with --device cpu,
and the refusal of data-parallel options. tests/test_torch_train.py holds
the trainer against the JAX package's."""

import importlib.util
import json
import os

import h5py
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.cli import train as tcli
from fast_artistic_videos_tpu_torch.core import device as device_mod
from fast_artistic_videos_tpu_torch.core.config import TrainOptions
from fast_artistic_videos_tpu_torch.models import registry
from fast_artistic_videos_tpu_torch.train import data as tdata
from fast_artistic_videos_tpu_torch.train.trainer import Trainer, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "c3s1-4,d8,R8,U2,c3s1-3"
HW = 32


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vgg_path(smoke, tmp_path_factory):
    return smoke.vgg_npz(smoke.EVAL_VGG_SEED, str(tmp_path_factory.mktemp("vgg") / "vgg16.npz"))


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    coco, video = str(d / "coco.h5"), str(d / "video.h5")
    with h5py.File(coco, "w") as f:
        for split in ("train2014", "val2014"):
            f.create_dataset(f"/{split}/images",
                             data=rng.integers(0, 256, (8, 3, HW, HW), dtype=np.uint8))
    with h5py.File(video, "w") as f:
        for split in ("train", "val"):
            f.create_dataset(f"/{split}/frames1",
                             data=rng.integers(0, 256, (6, 5, 3, HW, HW), dtype=np.uint8))
            f.create_dataset(f"/{split}/flow",
                             data=rng.normal(size=(6, 4, 2, HW, HW)).astype(np.float32))
            f.create_dataset(f"/{split}/cert",
                             data=rng.integers(0, 256, (6, 4, HW, HW), dtype=np.uint8))
    return coco, video


def _kw(coco, video="", **kw):
    base = dict(arch=ARCH, h5_file=coco, h5_file_video=video,
                data_mix="shift:1,zoom_out:1" + (",video:2" if video else ""),
                train_img_size=f"{HW}:{HW}", batch_size=2, style_layers="4,9",
                style_weights="10.0", content_layers="9", content_weights="1.0",
                print_every=1000, history_every=1, checkpoint_every=10 ** 9, images_every=0,
                num_val_batches=1)
    base.update(kw)
    return base


def _port(kw):
    return Trainer(TrainOptions(**kw), device="cpu")



def _grad_abs_sum(tt, imgs, flows, certs, steps):
    with device_mod.float32_convs():
        loss, _ = tt._loss_fn(tt.params, tt._to_device(*imgs), tt._to_device(*flows),
                              tt._to_device(*certs), steps, "self")
        grads = torch.autograd.grad(loss, leaves(tt.params), allow_unused=True)
    return sum(float(g.abs().sum()) for g in grads if g is not None)


def test_gradient_only_through_last_step(h5_files):
    """The earlier unrolled steps are forward only (train_video.lua:371-373):
    with full_bptt the gradient differs."""
    tt = _port(_kw(h5_files[0], data_mix="shift:1", num_frame_steps="0:2",
                   percep_loss_weight=0.0))
    images = tt.image_source.next_images("train")
    batch = tdata.shift_batch(images, 2, np.random.default_rng(0))
    last = _grad_abs_sum(tt, *batch, 2)
    tt.opt.full_bptt = True
    full = _grad_abs_sum(tt, *batch, 2)
    assert last > 0 and abs(last - full) / last > 1e-4


def test_loss_decreases(h5_files):
    tt = _port(_kw(h5_files[0], data_mix="shift:1", num_iterations=12, learning_rate="1e-2",
                   pixel_loss_weight=50.0, percep_loss_weight=0.0, history_every=2))
    tt.train(log_fn=lambda *a: None)
    hist = tt.train_loss_history
    assert len(hist) == 6 and hist[-1] < hist[0]


def test_trainer_with_all_sources_and_styles(h5_files, tmp_path):
    """Every data source (shift, zoom_out, video) and a style image (the
    bundled candy fixture), the frame-step schedule, validation, the
    checkpoint files, the debug dumps and the history JSON."""
    kw = _kw(*h5_files, num_iterations=4, style_image=registry.style_fixture("candy"),
             style_image_size=64, num_frame_steps="0:1,2:2", images_every=3,
             checkpoint_name=str(tmp_path / "ckpt"), checkpoint_every=4)
    tt = _port(kw)
    logs = []
    tt.train(log_fn=logs.append)
    assert tt.iteration == 4 and len(tt.val_loss_history) == 1
    for suffix in (".json", "_2.npz", "_state.pt", "_state.rng.json"):
        assert os.path.exists(str(tmp_path / "ckpt") + suffix), suffix
    assert os.path.exists(tmp_path / "debug" / "in2.png")
    assert all(np.isfinite(tt.train_loss_history))


def test_trainer_with_vr_source(h5_files):
    tt = _port(_kw(h5_files[0], data_mix="vr:1", num_iterations=2, train_img_size="256:256",
                   percep_loss_weight=0.0))
    before = [t.detach().clone() for t in leaves(tt.params)]
    tt.train(log_fn=lambda *a: None)
    assert tt.iteration == 2
    assert all(bool(torch.isfinite(t).all()) for t in leaves(tt.params))
    assert any(bool((a != b).any()) for a, b in zip(before, leaves(tt.params)))


def test_elastic_resume_is_bit_identical(h5_files, tmp_path):
    """Stop at iteration 3, restore into a fresh trainer, continue to 6:
    parameters, optimizer state and histories bit-identical to an
    uninterrupted 6-iteration run (the checkpoint carries the data RNG,
    the torch generator, the cursors and the accumulators)."""
    kw = _kw(h5_files[0], data_mix="shift:1,zoom_out:1", percep_loss_weight=0.0,
             checkpoint_every=3, fill_occlusions="uniform-random", history_every=2)
    full = _port({**kw, "num_iterations": 6, "checkpoint_name": str(tmp_path / "c")})
    full.train(log_fn=lambda *a: None)
    first = _port({**kw, "num_iterations": 3, "checkpoint_name": str(tmp_path / "d")})
    first.train(log_fn=lambda *a: None)
    resumed = _port({**kw, "num_iterations": 6, "checkpoint_name": str(tmp_path / "d")})
    resumed.restore_train_state(str(tmp_path / "d") + "_state")
    assert resumed.iteration == 3
    resumed.train(log_fn=lambda *a: None)
    for a, b in zip(leaves(full.params), leaves(resumed.params)):
        assert torch.equal(a, b)
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for k in sa:
        assert all(torch.equal(sa[k][n], sb[k][n]) for n in sa[k])
    assert full.train_loss_history == resumed.train_loss_history
    assert full.val_loss_history == resumed.val_loss_history


@pytest.mark.parametrize("fault", ["", "fresh optimizer", "data generator from its seed"])
def test_resume_check_rejects_planted_faults(smoke, h5_files, tmp_path, fault):
    """chip_smoke.py phase 14's resume check on the CPU: a trainer restored
    at iteration 3 and run on to 6 beside an uninterrupted run has no gap
    (the CPU resume is bit-identical) and meets the float32 limits; each
    planted fault (Adam afresh, the data generator from its seed) misses
    them."""
    assert fault in smoke.RESUME_FAULTS
    kw = _kw(h5_files[0], data_mix="shift:1,zoom_out:1", checkpoint_every=3)
    full = _port({**kw, "num_iterations": 6, "checkpoint_name": str(tmp_path / "c")})
    full.train(log_fn=lambda *a: None)
    first = _port({**kw, "num_iterations": 3, "checkpoint_name": str(tmp_path / "d")})
    first.train(log_fn=lambda *a: None)
    opt = TrainOptions(**{**kw, "num_iterations": 6, "checkpoint_name": str(tmp_path / "d")})
    resumed = Trainer(opt, device="cpu")
    resumed.restore_train_state(str(tmp_path / "d") + "_state")
    smoke._plant(fault, resumed, opt)
    at_ck = smoke._param_copy(resumed)
    resumed.train(log_fn=lambda *a: None)
    cancelled = smoke.cancelled_biases(full.spec)
    assert cancelled == {"layer00/b", "layer01/b", "layer02/conv1/b", "layer02/conv2/b",
                         "layer02/norm2/bias"}   # tests/test_torch_train.py's CANCELLED
    gap = smoke.resume_gap(full, resumed, at_ck, 3, cancelled)
    misses = smoke.resume_misses(gap, "float32")
    if fault:
        assert misses, gap
    else:
        assert gap == {"loss": 0.0, "leaf": 0.0, "cancelled_abs": 0.0}


def test_cli_train_runs_on_the_cpu(h5_files, vgg_path, tmp_path):
    """cli/train.py end to end with --device cpu: the VGG .npz through
    load_vgg_params, 2 iterations, the final checkpoint; then a resume."""
    base = str(tmp_path / "cli")
    args = ["--arch", ARCH, "--h5_file", h5_files[0], "--data_mix", "shift:1,zoom_out:1",
            "--train_img_size", f"{HW}:{HW}", "--batch_size", "2", "--style_layers", "4,9",
            "--style_weights", "10.0", "--content_layers", "9", "--loss_network", vgg_path,
            "--style_image", registry.style_fixture("candy"), "--style_image_size", "48",
            "--num_iterations", "2", "--checkpoint_every", "2", "--num_val_batches", "1",
            "--images_every", "0", "--checkpoint_name", base, "--device", "cpu"]
    assert tcli.main(args) == 0
    for suffix in (".json", "_1.npz", "_state.pt"):
        assert os.path.exists(base + suffix), suffix
    args[args.index("--num_iterations") + 1] = "3"
    assert tcli.main(args + ["--resume_from_checkpoint", base + "_state"]) == 0
    with open(base + ".json") as f:
        assert json.load(f)["iter"] == 3


def test_trainer_refuses_data_parallel(h5_files):
    # data-parallel training needs a process group, one process per card
    # (tests/test_torch_parallel.py trains under one)
    with pytest.raises(RuntimeError, match="one process per card"):
        _port(_kw(h5_files[0], num_data_devices=2))
