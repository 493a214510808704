"""The port's style trainer (fast_artistic_videos_tpu_torch: train.trainer,
cli.train) against the JAX package's, with the JAX tests' small
architecture at 32 px, the parameters carried across from the JAX trainer,
a full-width VGG-16 from a numpy seed and the bundled candy style image.

Tolerances: the loss 1e-5 relative and each parameter leaf's gradient 1e-3
(relative L2) for one step (the JAX package's float32 CPU gradients carry
about 2e-4 relative error: held against float64, the port's float32
gradients are within 2e-6); the leaves whose exact gradient is 0 (the conv
biases that instance norm cancels) only have to stay below 1e-6 of the
largest leaf's norm on both sides. Three trainer iterations: losses 1e-4
relative, parameter updates 1e-3 relative L2 per leaf (Adam at lr 1e-4;
the cancelled biases move by float noise, within Adam's bound of lr per
element per step). The committed trainer fixture (chip_smoke.py phase 15 on
the card) is also held on the CPU, with check_train_parity's tolerances.
Adam with weight decay against optax to 1e-6. The port's model export
loads in the JAX package. tests/test_torch_train_loop.py tests the port's
trainer on its own (resume, the CLI, every source)."""

import dataclasses
import importlib.util
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_artistic_videos_tpu.core.config import TrainOptions as JOptions
from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jstylizer
from fast_artistic_videos_tpu.train import data as jdata
from fast_artistic_videos_tpu.train.trainer import Trainer as JTrainer
from fast_artistic_videos_tpu.video import evaluation as jev
from fast_artistic_videos_tpu_torch.core import device as device_mod
from fast_artistic_videos_tpu_torch.core.config import TrainOptions as TOptions
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import registry
from fast_artistic_videos_tpu_torch.models import stylizer as tstylizer
from fast_artistic_videos_tpu_torch.train.trainer import Trainer as TTrainer
from fast_artistic_videos_tpu_torch.train.trainer import leaves
from fast_artistic_videos_tpu_torch.video import evaluation as tev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "c3s1-4,d8,R8,U2,c3s1-3"
HW = 32
NOISE = 1e-6      # gradient norms below this share of the largest: cancelled biases
# ARCH's leaves whose exact gradient is 0: the conv biases before an
# instance norm, and the residual block's last norm bias (the upsample's
# instance norm follows it)
CANCELLED = {"layer00/b", "layer01/b", "layer02/conv1/b", "layer02/conv2/b",
             "layer02/norm2/bias"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("make_torch_parity_fixture", ("tools", "make_torch_parity_fixture.py"))


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ("chip_smoke.py",))


@pytest.fixture(scope="module")
def vgg_path(tool, tmp_path_factory):
    return tool.vgg_npz(tool.EVAL_VGG_SEED, str(tmp_path_factory.mktemp("vgg") / "vgg16.npz"))


@pytest.fixture(scope="module")
def h5_files(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "coco.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for split in ("train2014", "val2014"):
            f.create_dataset(f"/{split}/images",
                             data=rng.integers(0, 256, (8, 3, HW, HW), dtype=np.uint8))
    return (path,)


def _kw(coco, **kw):
    base = dict(arch=ARCH, h5_file=coco, data_mix="shift:1,zoom_out:1",
                train_img_size=f"{HW}:{HW}", batch_size=2, style_layers="4,9",
                style_weights="10.0", content_layers="9", content_weights="1.0",
                print_every=1000, history_every=1, checkpoint_every=10 ** 9, images_every=0,
                num_val_batches=1)
    base.update(kw)
    return base


def _port(kw, vgg_path=None):
    vgg = tev.load_vgg_params(vgg_path, "cpu") if vgg_path else None
    return TTrainer(TOptions(**kw), vgg_params=vgg, device="cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


PAIR_KW = dict(style_image=registry.style_fixture("candy"), style_image_size=64,
               learning_rate="1e-4", num_iterations=3)


@pytest.fixture(scope="module")
def pair(h5_files, vgg_path):
    """One JAX trainer (its jit compiles are the file's cost) and a port
    trainer carrying its parameters."""
    kw = _kw(h5_files[0], **PAIR_KW)
    jt = JTrainer(JOptions(**kw), vgg_params=jev.load_vgg_params(vgg_path))
    tt = _port(kw, vgg_path)
    init = _np_tree(jt.params)
    tt.set_params(init)
    return jt, tt, init


def _grads_close(jg, tg):
    """Per-leaf relative L2 of the port's gradient (flat {key: OIHW
    tensor}) against JAX's (flat {key: HWIO array}), and the cancelled
    leaves on both sides below NOISE of the largest norm."""
    tg = _flat(tckpt.params_to_numpy(tg))
    top = max(np.linalg.norm(v) for v in jg.values())
    top_t = max(np.linalg.norm(v) for v in tg.values())
    worst = 0.0
    for k, want in jg.items():
        got = tg[k]
        if np.linalg.norm(want) < NOISE * top:
            assert np.linalg.norm(got) < NOISE * top_t, k
            continue
        worst = max(worst, np.linalg.norm(got - want) / np.linalg.norm(want))
    assert worst <= 1e-3, worst


@pytest.mark.parametrize("num_steps,full_bptt", [(1, False), (2, False), (2, True)])
def test_loss_fn_and_gradients_match_jax(pair, num_steps, full_bptt):
    """_loss_fn and its gradient for one shift batch: 1 or 2 unrolled
    steps, gradients through the last step only or through all of them."""
    jt, tt, _ = pair
    images = np.random.default_rng(40 + num_steps).random((2, HW, HW, 3)).astype(np.float32)
    imgs, flows, certs = jdata.shift_batch(images, num_steps, np.random.default_rng(41))
    jt.opt.full_bptt = tt.opt.full_bptt = full_bptt
    try:
        (jl, (jaux, _, _)), jg = jax.value_and_grad(
            lambda p: jt._loss_fn(p, tuple(imgs), tuple(flows), tuple(certs),
                                  jax.random.PRNGKey(0), num_steps, "self"),
            has_aux=True)(jt.params)
        with device_mod.float32_convs():
            tl, (taux, _, _) = tt._loss_fn(tt.params, tt._to_device(*imgs),
                                           tt._to_device(*flows), tt._to_device(*certs),
                                           num_steps, "self")
            tg = torch.autograd.grad(tl, leaves(tt.params))
    finally:
        jt.opt.full_bptt = tt.opt.full_bptt = False
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(taux) == set(jaux)
    for k in jaux:
        assert abs(float(taux[k].detach()) - float(jaux[k])) <= 1e-5 * abs(float(jaux[k])) + 1e-6
    _grads_close(_flat(_np_tree(jg)), _unflat_like(tt.params, list(tg)))


def _unflat_like(tree, flat_leaves):
    it = iter(flat_leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in t.items()}
    return build(tree)


def test_three_iterations_match_jax(pair):
    """Three whole Trainer.train iterations (the data-mix wheel, the batch
    sources, Adam) from the same parameters: losses 1e-4, per-leaf updates
    1e-3 (relative L2), cancelled biases within Adam's bound."""
    jt, tt, init = pair
    jt.train(log_fn=lambda *a: None)
    tt.train(log_fn=lambda *a: None)
    np.testing.assert_allclose(tt.train_loss_history, jt.train_loss_history, rtol=1e-4)
    assert tt.iteration == jt.iteration == 3
    jf, tf, f0 = (_flat(t) for t in (_np_tree(jt.params), tckpt.params_to_numpy(tt.params),
                                     init))
    lr, worst = 1e-4, 0.0
    for k in jf:
        dj, dt = jf[k] - f0[k], tf[k] - f0[k]
        assert np.abs(dt).max() <= 3 * lr * 1.01, k
        if k in CANCELLED:
            continue   # noise-driven updates
        worst = max(worst, np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    assert worst <= 1e-3, worst


def test_trainer_fixture_on_the_cpu(smoke, tool, vgg_path):
    """The committed JAX trainer fixture (tests/fixtures/
    torch_parity_train.npz) against the port on the CPU, by phase 15's
    code (chip_smoke.train_parity_run / check_train_parity), from the
    seeded parameters, images and options the fixture tool takes from
    chip_smoke.py."""
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_train.npz")) as z:
        fx = {k: z[k] for k in z.files}
    assert int(fx["vgg_seed"]) == tool.EVAL_VGG_SEED
    assert int(fx["param_seed"]) == smoke.PARITY_PARAM_SEED
    assert int(fx["image_seed"]) == smoke.PARITY_IMAGE_SEED
    worst = smoke.check_train_parity(fx, smoke.train_parity_run(torch, "cpu", vgg_path))
    assert worst["loss"] <= 1e-4


def test_cancelled_biases_match_the_fixture(smoke):
    """chip_smoke.cancelled_biases (the conv biases an instance norm
    follows, which phase 14's resume check holds to Adam's bound instead
    of a relative limit) names exactly the canonical architecture's leaves
    whose gradient norm in the JAX trainer's fixture is below 1e-6 of the
    largest."""
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_train.npz")) as z:
        norms = {k[len("grad_norm/"):]: float(z[k]) for k in z.files
                 if k.startswith("grad_norm/")}
    top = max(norms.values())
    spec = tstylizer.parse_arch(TOptions().arch, in_channels=7)
    assert smoke.cancelled_biases(spec) == {k for k, v in norms.items() if v < 1e-6 * top}
    assert len(smoke.cancelled_biases(spec)) == 15


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_and_weight_decay_match_optax(weight_decay):
    """torch.optim.Adam's coupled weight_decay is
    optax.chain(add_decayed_weights(wd), adam), with the learning rate set
    per step (optax.inject_hyperparams): 6 steps on seeded gradients."""
    rng = np.random.default_rng(50)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(6)]
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 1e-3, 1e-3]
    tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.add_decayed_weights(weight_decay), optax.adam(learning_rate)))(
            learning_rate=lrs[0])
    pj, state = jnp.asarray(p0), None
    state = tx.init(pj)
    pt = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = torch.optim.Adam([pt], lr=lrs[0], weight_decay=weight_decay)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0, atol=1e-6)


def test_port_checkpoint_loads_in_the_jax_package(h5_files, tmp_path):
    """The port's model export is the JAX package's .npz: its load_model
    reads it, and both stylizers give the same output (1e-4 of the output
    range; the JAX reference runs without its TPU graph rewrites)."""
    kw = _kw(h5_files[0], data_mix="shift:1", num_iterations=2, percep_loss_weight=0.0,
             checkpoint_every=2, checkpoint_name=str(tmp_path / "m"))
    tt = _port(kw)
    tt.train(log_fn=lambda *a: None)
    spec, params, meta = jckpt.load_model(str(tmp_path / "m") + "_1.npz")
    assert meta["arch"] == ARCH and meta["iter"] == 2
    x = np.random.default_rng(60).normal(size=(1, 40, 44, 7)).astype(np.float32) * 50
    want = np.asarray(jstylizer.apply(params, spec, jnp.asarray(x), optimize=False))
    tspec, tparams, _ = tckpt.load_model(str(tmp_path / "m") + "_1.npz", "cpu")
    got = tstylizer.apply(tparams, tspec, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    direct = tstylizer.apply(tt.params, tt.spec, torch.from_numpy(x), fused=False)
    np.testing.assert_array_equal(direct.detach().numpy(), got)


def test_options_are_the_jax_packages():
    assert [f.name for f in dataclasses.fields(TOptions)] == \
        [f.name for f in dataclasses.fields(JOptions)]
    assert dataclasses.asdict(TOptions()) == dataclasses.asdict(JOptions())

