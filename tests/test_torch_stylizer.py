"""The port's stylizer ``apply`` (plain path) against the JAX package's
``apply``, on the bundled demo checkpoint and on random specs covering every
arch token and padding type. Inputs are made with numpy from a seed; float32
outputs agree within 1e-3 after deprocessing (/255), bfloat16 within 1e-2
mean-abs."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import arch_dsl, checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu_torch.models import arch_dsl as tarch
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty


def parse_both(arch, **kw):
    """The same arch string parsed by the JAX package's parser and by the
    port's own copy of it: (JAX spec, port spec)."""
    return arch_dsl.parse_arch(arch, **kw), tarch.parse_arch(arch, **kw)


def same_spec(a, b) -> bool:
    """A JAX spec and a port spec describe the same network."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def numpy_params(spec, seed):
    """Random parameters with the tree and the distributions of the JAX
    package's ``init_params``, drawn with numpy from `seed` (the eager
    jax.random init compiles dozens of small programs per spec). Returns
    the JAX tree; the port takes it through ``params_from_numpy``."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return jnp.asarray(np.asarray(a, np.float32))

    def draw(node):
        if "w" in node:                                     # conv: U(-stdv, stdv)
            kh, kw, cin, _ = node["w"].shape
            stdv = 1.0 / np.sqrt(kh * kw * cin)
            return {k: f32(rng.uniform(-stdv, stdv, node[k].shape)) for k in ("w", "b")}
        if "scale" in node:                                 # instance or batch norm
            ch = node["scale"].shape
            scale = rng.uniform(0.0, 1.0, ch) if spec.use_instance_norm else np.ones(ch)
            return {"scale": f32(scale), "bias": f32(np.zeros(ch))}
        return {k: draw(v) for k, v in node.items()}

    return draw(jax.eval_shape(lambda: jsty.init_params(jax.random.PRNGKey(0), spec)))


def jax_apply(params, spec, x, optimize=False, **kw):
    """The JAX package's ``apply`` under one jit (one compile, where the
    eager call compiles every op on its own). ``optimize=False`` by default:
    it turns off the exact-math TPU graph rewrites, which the port leaves
    out and which multiply the CPU compile time several times over (the
    JAX CLI runs in test_torch_cli.py cover the rewritten graph)."""
    return jax.jit(lambda p, v: jsty.apply(p, spec, v, optimize=optimize, **kw))(
        params, jnp.asarray(x))


def _to_torch(params_jax):
    return tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_jax), device="cpu")


def _run_both(spec, tspec, params_jax, x, dtype=None, **tkw):
    want = jax_apply(params_jax, spec, x,
                     dtype=jnp.bfloat16 if dtype == torch.bfloat16 else None)
    got = tsty.apply(_to_torch(params_jax), tspec, torch.from_numpy(x), dtype=dtype, **tkw)
    return got.float().numpy(), np.asarray(want, np.float32)


def _vgg_input(rng, n, h, w, c=7):
    return (rng.standard_normal((n, h, w, c)) * 60).astype(np.float32)


def test_demo_checkpoint_f32():
    spec, params, _ = jckpt.load_model("demo")
    tspec = tckpt.load_model("demo", device="cpu")[0]
    x = _vgg_input(np.random.default_rng(0), 1, 48, 64)
    got, want = _run_both(spec, tspec, params, x)
    assert got.shape == want.shape == (1, 48, 64, 3)
    assert np.abs(got - want).max() / 255.0 < 1e-3


def test_demo_checkpoint_bf16():
    spec, params, _ = jckpt.load_model("demo")
    tspec = tckpt.load_model("demo", device="cpu")[0]
    x = _vgg_input(np.random.default_rng(1), 1, 48, 56)
    got, want = _run_both(spec, tspec, params, x, dtype=torch.bfloat16)
    assert np.abs(got - want).mean() / 255.0 < 1e-2


def test_port_loader_matches_jax_loader():
    spec_j, params_j, meta_j = jckpt.load_model("demo")
    spec_t, params_t, meta_t = tckpt.load_model("demo", device="cpu")
    assert isinstance(spec_t, tarch.ModelSpec)
    assert same_spec(spec_t, spec_j) and meta_t == meta_j
    w_j = np.asarray(params_j["layer00"]["w"])                  # HWIO
    np.testing.assert_array_equal(params_t["layer00"]["w"].numpy(),
                                  w_j.transpose(3, 2, 0, 1))    # OIHW


def test_explicit_layers_meta(tmp_path):
    """A checkpoint whose meta lists its layers (the t7-import form)."""
    spec, tspec = parse_both("c3s1-8,d8,R8,u8,c3s1-3", in_channels=7,
                             padding_type="zero")
    params = numpy_params(spec, 3)
    meta = {"layers": [dict(vars(l)) for l in spec.layers], "in_channels": 7,
            "padding_type": "zero", "use_instance_norm": True,
            "tanh_constant": 150.0, "input_pad": 0, "total_stride": 2}
    path = os.path.join(tmp_path, "m.npz")
    jckpt.save_model(path, params, meta)
    spec_t, params_t, _ = tckpt.load_model(path, device="cpu")
    assert spec_t == tspec and same_spec(spec_t, jckpt.load_model(path)[0])
    x = _vgg_input(np.random.default_rng(3), 1, 16, 20)
    got = tsty.apply(params_t, spec_t, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_apply(params, spec, x))
    assert np.abs(got - want).max() / 255.0 < 1e-3


def _random_arch(rng):
    """c / f / d / u / U / C / R tokens, returning to stride 1."""
    ch = int(rng.choice([4, 8]))
    tokens = [f"c{rng.choice([3, 5])}s1-{ch}"]
    stride = 1
    for _ in range(int(rng.integers(1, 4))):
        kind = rng.choice(["d", "R", "C", "c"])
        if kind == "d" and stride < 4:
            ch = int(rng.choice([8, 12]))
            tokens.append(f"d{ch}")
            stride *= 2
        elif kind == "R":
            tokens.append(f"R{ch}")
        elif kind == "C":
            tokens.append(f"C{ch}")
        else:
            tokens.append(f"c3s1-{ch}")
    while stride > 1:
        tokens.append(str(rng.choice(["U2", "u8", "f3s2-6"])))
        stride //= 2
    tokens.append("c3s1-3")
    return ",".join(tokens)


PADDINGS = ["zero", "reflect", "replicate", "none", "reflect-start"]


@pytest.mark.parametrize("seed", range(6))
def test_random_specs_f32(seed):
    rng = np.random.default_rng(100 + seed)
    padding = PADDINGS[seed % len(PADDINGS)]
    arch = _random_arch(rng)
    use_in = seed != 5                         # one batch-norm spec
    spec, tspec = parse_both(arch, in_channels=7, padding_type=padding,
                             use_instance_norm=use_in)
    params = numpy_params(spec, seed)
    size = 12 * spec.total_stride
    n = 2 if seed % 3 == 0 else 1
    x = _vgg_input(rng, n, size, size + 4 * spec.total_stride)
    got, want = _run_both(spec, tspec, params, x)
    assert got.shape == want.shape, (arch, padding)
    assert np.abs(got - want).max() / 255.0 < 1e-3, (arch, padding)


def test_stop_after_start_at_compose():
    spec, tspec = parse_both("c9s1-8,d16,d16,R16,R16,u8,u8,c9s1-3", in_channels=7)
    pj = numpy_params(spec, 5)
    params = _to_torch(pj)
    x = torch.from_numpy(_vgg_input(np.random.default_rng(5), 1, 24, 32))
    full = tsty.apply(params, tspec, x)
    mid = tsty.apply(params, tspec, x, stop_after=3)
    rest = tsty.apply(params, tspec, mid, start_at=4)
    torch.testing.assert_close(rest, full, rtol=0, atol=1e-4)
    want_mid = jax_apply(pj, spec, x.numpy(), stop_after=3)
    np.testing.assert_allclose(mid.numpy(), np.asarray(want_mid), rtol=1e-4, atol=1e-3)


def test_transposed_conv_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 7, 9, 5)).astype(np.float32)
    for k, s, p, a in [(3, 2, 1, 1), (4, 2, 1, 0), (3, 1, 1, 0), (5, 3, 2, 2)]:
        w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
        b = rng.standard_normal(6).astype(np.float32)
        want = np.asarray(jsty.conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(b), s, p, a))
        got = tsty.conv_transpose2d(torch.from_numpy(x),
                                    torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                    torch.from_numpy(b), s, p, a)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_instance_norm_matches_jax():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 9, 13, 6)) * 3 + 5).astype(np.float32)
    s = rng.random(6).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jsty.instance_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tsty.instance_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
