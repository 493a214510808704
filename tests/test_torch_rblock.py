"""Kernel K2 (the residual chain's instance-norm conv) in the port: its plain
version against the JAX package's Pallas ``rblock_pallas.chain_conv`` in
interpret mode, for the prologues the chain uses, and the port's fused
residual chain against the JAX package's. The JAX kernel runs on its
constant physical chain geometry; its outputs are cropped to the valid
extent the port computes directly. float32 rtol 1e-4, bfloat16 rtol 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import arch_dsl
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.ops import rblock_pallas as rbp
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import rblock_kernel
from tests.test_torch_stylizer import jax_apply, numpy_params, parse_both

H_IN, W_IN, C = 14, 19, 8


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((H_IN, W_IN, C)).astype(np.float32)
    skip = rng.standard_normal((H_IN + 4, W_IN + 4, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.2).astype(np.float32)   # HWIO
    b = rng.standard_normal(C).astype(np.float32)
    eff = np.stack([rng.random(C) + 0.5, rng.standard_normal(C) * 0.3]).astype(np.float32)
    return x, skip, w, b, eff


def _jax_chain_conv(x, skip, w, b, eff, relu, emit, dtype):
    hp, wp = rbp.chain_geometry(H_IN - 2, W_IN - 2, dtype)
    hp = max(hp, -(-(H_IN + 4) // 8) * 8 + 8)  # room for the skip's rows
    xp = jnp.zeros((hp, wp, C), dtype).at[:H_IN, :W_IN].set(jnp.asarray(x, dtype))
    sp = None
    if skip is not None:
        sp = jnp.zeros((hp, wp, C), dtype).at[:H_IN + 4, :W_IN + 4].set(
            jnp.asarray(skip, dtype))
    out = rbp.chain_conv(xp, jnp.asarray(w), jnp.asarray(b), (H_IN - 2, W_IN - 2),
                         eff=None if eff is None else jnp.asarray(eff),
                         pre_relu=relu, skip=sp, emit_input=emit, interpret=True)
    y = np.asarray(out[0][:H_IN - 2, :W_IN - 2], np.float32)
    a = np.asarray(out[2][:H_IN, :W_IN], np.float32) if emit else None
    return y, np.asarray(out[1]), a


def _close(got, want, rtol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# (eff, relu, skip, emit): the bare conv (a chain's first conv1 with no
# pending norm), the other launches the chain makes (its first conv1 with
# a pending norm + ReLU, a later conv1 with the residual add, a conv2), the
# emission alone, and every step at once
PROLOGUES = [(False, False, False, False), (True, True, False, True),
             (False, False, False, True), (True, False, True, True),
             (True, True, False, False), (True, True, True, True)]


@pytest.mark.parametrize("has_eff,relu,has_skip,emit", PROLOGUES)
def test_chain_conv_prologues_f32(has_eff, relu, has_skip, emit):
    x, skip, w, b, eff = _case(1)
    eff = eff if has_eff else None
    skip = skip if has_skip else None
    y, st, a = _jax_chain_conv(x, skip, w, b, eff, relu, emit, jnp.float32)
    out = rblock_kernel.chain_conv(
        torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), eff=None if eff is None else torch.from_numpy(eff),
        pre_relu=relu, skip=None if skip is None else torch.from_numpy(skip),
        emit_input=emit)
    assert out[0].shape == (H_IN - 2, W_IN - 2, C)
    _close(out[0].numpy(), y, 1e-4)
    _close(out[1].numpy(), st, 1e-4)
    if emit:
        _close(out[2].numpy(), a, 1e-4)


@pytest.mark.parametrize("has_skip", [False, True])
def test_chain_conv_bf16(has_skip):
    x, skip, w, b, eff = _case(2)
    skip = skip if has_skip else None
    xb = torch.from_numpy(x).to(torch.bfloat16)
    sb = None if skip is None else torch.from_numpy(skip).to(torch.bfloat16)
    y, st, a = _jax_chain_conv(xb.float().numpy(), None if sb is None else sb.float().numpy(),
                               w, b, eff, True, True, jnp.bfloat16)
    out = rblock_kernel.chain_conv(
        xb, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
        eff=torch.from_numpy(eff), pre_relu=True, skip=sb, emit_input=True)
    assert out[0].dtype == torch.bfloat16
    _close(out[0].float().numpy(), y, 2e-2)
    _close(out[1].numpy(), st, 2e-2)
    _close(out[2].float().numpy(), a, 2e-2)


ARCH = "c9s1-8,d16,d16,R16,R16,R16,u8,u8,c9s1-3"


def test_fused_res_chain_matches_jax():
    spec = arch_dsl.parse_arch(ARCH, in_channels=7)
    pj = numpy_params(spec, 4)
    pt = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 27, 33, 16)).astype(np.float32)
    eff = np.stack([rng.random(16) + 0.5, rng.standard_normal(16) * 0.2]).astype(np.float32)
    chain = (3, 4, 5)
    want = np.asarray(jsty._fused_res_chain(pj, jnp.asarray(x), chain,
                                            pre_eff=jnp.asarray(eff), pre_relu=True,
                                            interpret=True))
    got = tsty.fused_res_chain(pt, torch.from_numpy(x), chain,
                               pre_eff=torch.from_numpy(eff), pre_relu=True).numpy()
    assert got.shape == want.shape == (1, 15, 21, 16)
    _close(got, want, 1e-4)


def test_apply_fused_chain_matches_jax_fused_rblocks():
    """Port apply with the kernels on (CPU: their plain versions) against
    the JAX package's apply(fused_rblocks=True)."""
    spec, tspec = parse_both(ARCH, in_channels=7)
    pj = numpy_params(spec, 6)
    pt = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    x = (np.random.default_rng(6).standard_normal((1, 32, 40, 7)) * 60).astype(np.float32)
    want = np.asarray(jax_apply(pj, spec, x, fused_rblocks=True))
    got = tsty.apply(pt, tspec, torch.from_numpy(x), fused=True).numpy()
    assert np.abs(got - want).max() / 255.0 < 1e-3

