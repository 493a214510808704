"""The port's flow-estimator training (fast_artistic_videos_tpu_torch:
flow.estimator's training half, flow.train) against the JAX package's,
from the bundled weights carried through the JAX package's save_params and
the port's load_params. tests/test_torch_flow_eval.py holds
evaluate_heldout, cli/train_flownet.py and the flow tools.

Tolerances: the host-side sampling (fields, images, pairs) 1e-5 of each
array's largest value (numpy on both sides; the bicubic resizes in torch
and jax.image.resize); apply_multiscale's estimates 1e-4 of their largest
value; the multiscale loss 1e-5 relative and its gradient 2e-3 relative L2
per leaf (the JAX package's float32 CPU gradients carry up to 6e-4
relative error here: in float64 the two agree to 3e-7); two training
iterations: the logged losses to their printed 4 decimals (train_flow) or
1e-3 relative (train_flow_synthetic), and the parameter updates 2e-2
relative L2 per leaf (Adam's first steps move each element by about
the learning rate whatever its gradient's size, so an element whose
gradient is at the float32 noise floor moves differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.flow import estimator as jest
from fast_artistic_videos_tpu.flow import train as jtrain
from fast_artistic_videos_tpu_torch.flow import estimator as test_
from fast_artistic_videos_tpu_torch.flow import train as ttrain


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The bundled weights in both packages, carried through the JAX
    package's save_params and the port's load_params."""
    path = str(tmp_path_factory.mktemp("flow") / "w.npz")
    jp = jest.load_params("bundled")
    jest.save_params(path, jp)
    return jp, test_.load_params(path, "cpu")


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _hwio(t):
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


@pytest.mark.parametrize("name,h,w", [
    ("random_flow_field", 40, 56), ("random_flow_field_discontinuous", 48, 48),
    ("random_texture_image", 36, 52), ("natural_image", 40, 40),
    ("natural_image_augmented", 44, 60),
])
def test_sampling_matches_jax(name, h, w):
    for seed in (1, 2):
        _close(getattr(ttrain, name)(np.random.default_rng(seed), h, w),
               getattr(jtrain, name)(np.random.default_rng(seed), h, w))


def test_make_pair_matches_jax():
    images = np.random.default_rng(3).random((3, 48, 64, 3)).astype(np.float32)
    got = ttrain.make_pair(images, np.random.default_rng(4), p_discontinuous=0.5)
    want = jtrain.make_pair(images, np.random.default_rng(4), p_discontinuous=0.5)
    for g, wt in zip(got, want):
        _close(g, wt)


def test_fields_from_seeds_match_jax():
    """The synthetic trainer's batched field synthesis against the JAX
    package's per-sample ``_field_from_seeds`` (vmapped)."""
    rng = np.random.default_rng(5)
    n, size = 4, 48
    affine = np.concatenate([rng.uniform(-12, 12, (n, 2)), rng.uniform(-0.05, 0.05, (n, 1)),
                             rng.uniform(-0.08, 0.08, (n, 1))], 1).astype(np.float32)
    affine_b = affine[::-1].copy()
    coarse = rng.normal(0, 3, (n, 4, 4, 2)).astype(np.float32)
    bnd = rng.normal(size=(n, 3, 3)).astype(np.float32)
    flags = np.asarray([0, 1, 0, 1], np.float32)
    want = jax.vmap(lambda a, c, b, a2, f: jtrain._field_from_seeds(size, size, a, c, b, a2, f,
                                                                    12.0))(
        *(jnp.asarray(x) for x in (affine, coarse, bnd, affine_b, flags)))
    got = ttrain.fields_from_seeds(size, *(torch.from_numpy(x) for x in (affine, coarse, bnd,
                                                                          affine_b, flags)))
    _close(got, want)


def test_init_save_and_context_match_jax(tmp_path):
    """init_params' tree and shapes are the JAX package's (with and without
    the context head); save_params writes what the JAX load_params reads;
    add_context grafts a head that changes no estimate until trained."""
    g = torch.Generator().manual_seed(0)
    for context in (False, True):
        tp = test_.init_params(g, context=context, device="cpu")
        jp = jax.eval_shape(lambda: jest.init_params(jax.random.PRNGKey(0), context=context))
        assert {k: {n: _hwio(t).shape for n, t in v.items()} for k, v in tp.items()} == \
            {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in jp.items()}
    assert float(tp["ctx_out"]["w"].abs().max()) == 0.0
    test_.save_params(str(tmp_path / "p.npz"), tp)
    back = jest.load_params(str(tmp_path / "p.npz"))
    for k, v in tp.items():
        for n, t in v.items():
            np.testing.assert_array_equal(np.asarray(back[k][n]), _hwio(t))
    bare = {k: v for k, v in tp.items() if not k.startswith("ctx")}
    grafted = test_.add_context(bare, torch.Generator().manual_seed(1))
    assert set(grafted) == set(tp)
    img = torch.from_numpy(np.random.default_rng(6).random((1, 32, 32, 3)).astype(np.float32))
    torch.testing.assert_close(test_.apply(grafted, img, img.flip(2)),
                               test_.apply(bare, img, img.flip(2)), rtol=0, atol=1e-6)


def test_multiscale_loss_and_gradients_match_jax(weights):
    jp, tp = weights
    images = np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)
    i1, i2, gt = ttrain.make_pair(images, np.random.default_rng(8))

    def loss_and_outs(p):
        return (jtrain.multiscale_loss(p, *(jnp.asarray(a) for a in (i1, i2, gt))),
                jest.apply_multiscale(p, jnp.asarray(i1), jnp.asarray(i2)))
    (jl, jouts), jg = jax.jit(jax.value_and_grad(loss_and_outs, has_aux=True))(jp)
    with torch.no_grad():
        touts = test_.apply_multiscale(tp, torch.from_numpy(i1), torch.from_numpy(i2))
    assert len(touts) == len(jouts)
    for g, w in zip(touts, jouts):
        _close(g, w, 1e-4)
    params = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
              for k, v in tp.items()}
    tl = ttrain.multiscale_loss(params, *(torch.from_numpy(a) for a in (i1, i2, gt)))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * float(jl)
    for k, v in params.items():
        for n, t in v.items():
            want = np.asarray(jg[k][n])
            assert np.linalg.norm(_hwio(t.grad) - want) <= 2e-3 * np.linalg.norm(want), (k, n)


def _updates_close(got, want, init):
    for k in want:
        for n in want[k]:
            dw = np.asarray(want[k][n]) - np.asarray(init[k][n])
            dg = _hwio(got[k][n]) - np.asarray(init[k][n])
            assert np.linalg.norm(dg - dw) <= 2e-2 * np.linalg.norm(dw), (k, n)


def test_train_flow_iterations_match_jax(weights):
    """Two train_flow iterations (make_pair from the seed, Adam) from the
    same weights and images."""
    jp, tp = weights
    images = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    jlog, tlog = [], []
    want = jtrain.train_flow(lambda: images, iterations=2, seed=1, params=jp,
                             log_fn=jlog.append, log_every=1)
    got = ttrain.train_flow(lambda: images, iterations=2, seed=1, params=tp,
                            log_fn=tlog.append, log_every=1, device="cpu")
    assert tlog == jlog
    _updates_close(got, want, jp)


def test_train_flow_synthetic_iterations_match_jax(weights):
    """Two train_flow_synthetic iterations: the image pool (procedural and
    natural), the seeds drawn up front, the learning-rate decay (from
    iteration 2 of 2 at lr_decay_at 0.5)."""
    jp, tp = weights
    kw = dict(iterations=2, batch_size=2, size=64, pool=4, seed=1, natural_frac=0.5,
              lr_decay_at=0.5, log_every=1)
    jlog, tlog = [], []
    want = jtrain.train_flow_synthetic(params=jp, log_fn=jlog.append, **kw)
    got = ttrain.train_flow_synthetic(params=tp, log_fn=tlog.append, device="cpu", **kw)
    jl = [float(s.split()[-1]) for s in jlog]
    tl = [float(s.split()[-1]) for s in tlog]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)   # printed with 4 decimals
    _updates_close(got, want, jp)
