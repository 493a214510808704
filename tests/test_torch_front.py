"""Kernel K3 (the stylizer front's instance-norm conv) in the port: the
port's three-launch front (layers 0-2 on the logical grid, CPU: the
kernel's plain version) against the JAX package's level-2 phase-domain
Pallas front ``_phase_front_pallas2`` in interpret mode, on z, its
statistics and their pixel count (float32 rtol 1e-4), and the whole
kernel-path ``apply`` on the demo model against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.ops import front_kernel
from tests.test_torch_stylizer import jax_apply, numpy_params, parse_both


def _params(pj):
    return tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("arch,hw", [("c9s1-8,d16,d32,R32,u16,u8,c9s1-3", (40, 56)),
                                     ("c5s1-16,d16,d32,R32,u16,u8,c9s1-3", (44, 36))])
def test_front_matches_jax_phase_front(arch, hw):
    spec, tspec = parse_both(arch, in_channels=7)
    pj = numpy_params(spec, 2)
    pt = _params(pj)
    x = (np.random.default_rng(2).standard_normal((1, *hw, 7)) * 60).astype(np.float32)
    z_j, st_j, cnt_j = jsty._phase_front_pallas2(
        jnp.asarray(x), pj["layer00"], spec.layers[0], pj["layer00_norm"],
        pj["layer01"], pj["layer01_norm"], pj["layer02"], interpret=True)
    z_t, st_t, cnt_t = tsty.front_layers(
        torch.from_numpy(x), pt["layer00"], tspec.layers[0], pt["layer00_norm"],
        pt["layer01"], pt["layer01_norm"], pt["layer02"])
    assert cnt_t == cnt_j
    assert tuple(z_t.shape) == z_j.shape == (1, hw[0] // 4, hw[1] // 4, 32)
    _close(z_t.numpy(), np.asarray(z_j), 1e-4)
    _close(st_t.numpy()[0], np.asarray(st_j)[0], 1e-4)
    _close(st_t.numpy()[1], np.asarray(st_j)[1], 1e-4)


def test_same_conv_zero_padding_after_prologue():
    """A padded tap reads 0, not the prologue of 0 (eff bias + ReLU)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 11, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    b = torch.zeros(8)
    eff = torch.stack([torch.ones(4), torch.full((4,), 5.0)])
    y, st = front_kernel.same_conv(x, w, b, 2, 1, eff=eff, relu=True)
    a = torch.relu(x + 5.0)
    want = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], w, None, 2, 1)[0]
    torch.testing.assert_close(y, want.permute(1, 2, 0), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st[0], y.sum((0, 1)), rtol=1e-5, atol=1e-3)


def test_demo_apply_kernel_path_matches_jax_full_front():
    """The whole kernel path (front + chain; CPU: the kernels' plain
    versions) on the demo model against the JAX package's apply. The JAX
    Pallas front and chain themselves are held against the port above and
    in test_torch_rblock.py."""
    spec, pj, _ = jckpt.load_model("demo")
    tspec = tckpt.load_model("demo", device="cpu")[0]
    pt = _params(pj)
    x = (np.random.default_rng(4).standard_normal((1, 48, 64, 7)) * 60).astype(np.float32)
    want = np.asarray(jax_apply(pj, spec, x))
    got = tsty.apply(pt, tspec, torch.from_numpy(x), fused=True).numpy()
    assert np.abs(got - want).max() / 255.0 < 1e-3

