"""The port's height sharding (fast_artistic_videos_tpu_torch.parallel.spatial)
on the CPU: one frame split over 2 and 4 CPU shards of one process.

  * the canonical architecture at a reduced shape (1x128x96x7) against the
    JAX package's UNSHARDED ``stylizer.apply`` (atol 2e-3, the JAX
    package's own bar for its sharded forward, tests/test_parallel.py:238)
    and against the port's unsharded plain forward. The output is in VGG
    space, tanh * 150: the shards sum their norm statistics in another
    order, which moves the float32 output by a few 1e-6 of that scale, so
    the port-against-port bar is 1e-5 of the tanh constant (1.5e-3);
    measured 3.4e-4 at 2 shards. The CPU convs run on PyTorch's own
    kernels here (oneDNN off): oneDNN's conv on the unsharded forward's
    channels-last activations (the last conv, 9x9, 64 -> 3) moves the
    output by up to 6e-3 between processes on the same inputs, even with
    ``torch.backends.mkldnn.deterministic``;
  * every padding type and layer kind (zero, reflect, replicate, VALID
    blocks, transposed convs, nearest upsampling, conv blocks) against the
    port's unsharded forward (2 and 3 shards);
  * the halo gather against ``F.pad`` at the frame edges;
  * the (data, space) gradients: two gloo ranks, each splitting its rows
    over two CPU shards, against the JAX package's one-device gradients
    (tests/test_parallel.py:90): loss rtol 1e-5, gradients rtol 2e-4,
    atol 2e-3.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_ranks as ranks
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.train import losses
from fast_artistic_videos_tpu_torch.models import arch_dsl as tarch
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.parallel import mesh
from fast_artistic_videos_tpu_torch.parallel.spatial import (SpatialStylizer, gather_rows,
                                                             split_rows)
from test_torch_parallel import assert_grads_close
from test_torch_stylizer import jax_apply, numpy_params, parse_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this process: the suite runs several workers on
    the host's cores, and torch's thread pools on every core of every
    worker slow the small ops here by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def native_cpu_convs():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


@pytest.fixture(autouse=True)
def deterministic_cpu_convs():
    with native_cpu_convs():
        yield


@pytest.fixture(scope="module")
def canonical():
    """The canonical video net with seeded parameters, its input, and the
    JAX package's and the port's unsharded outputs."""
    spec, tspec = parse_both("canonical", in_channels=7)
    params = numpy_params(spec, 7)
    x = np.random.default_rng(0).random((1, 128, 96, 7)).astype(np.float32)
    tparams = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    want_jax = np.asarray(jax_apply(params, spec, x))
    with native_cpu_convs():
        want_port = tsty.apply(tparams, tspec, torch.from_numpy(x), fused=False)
    return tspec, tparams, x, want_jax, want_port


@pytest.mark.parametrize("k", [2, 4])
def test_canonical_shards_match_unsharded(canonical, k):
    tspec, tparams, x, want_jax, want_port = canonical
    sp = SpatialStylizer(tspec, tparams, devices=["cpu"] * k)
    shards = sp.shards(x)
    assert [(a, b) for a, b, _ in shards] == split_rows(128, k)
    out = torch.cat([t for *_, t in shards], dim=1)
    np.testing.assert_allclose(out.numpy(), want_jax, atol=2e-3)
    np.testing.assert_allclose(out.numpy(), want_port.numpy(), rtol=0,
                               atol=1e-5 * tspec.tanh_constant)


@pytest.mark.parametrize("arch,padding", [
    ("c3s1-8,d16,R16,U2,c3s1-3", "zero"),
    ("c3s1-8,d16,R16,C16,u8,c3s1-3", "reflect"),
    ("c3s1-8,d16,R16,f3s2-8,c3s1-3", "replicate"),
    ("c3s1-8,d16,R16,u8,c3s1-3", "none"),
    ("c9s1-8,d16,d16,R16,R16,u16,u8,c9s1-3", "reflect-start"),
])
def test_every_layer_kind_matches_unsharded(arch, padding):
    spec = tarch.parse_arch(arch, in_channels=7, padding_type=padding)
    params = tsty.init_params(torch.Generator().manual_seed(1), spec, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).random((2, 44, 24, 7)).astype(np.float32))
    want = tsty.apply(params, spec, x, fused=False)
    for k in (2, 3):
        got = SpatialStylizer(spec, params, devices=["cpu"] * k)(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * spec.tanh_constant, err_msg=f"{k} shards")


@pytest.mark.parametrize("mode,pad", [("reflect", "reflect"), ("replicate", "replicate"),
                                      ("zero", "constant")])
def test_gather_rows_pads_at_the_frame_edges(mode, pad):
    x = torch.arange(2 * 11 * 3, dtype=torch.float32).reshape(1, 11, 2, 3)
    shards = [(a, b, x[:, a:b]) for a, b in split_rows(11, 3)]
    want = F.pad(x.permute(0, 3, 1, 2), (0, 0, 4, 4), mode=pad).permute(0, 2, 3, 1)
    for lo, hi in ((-4, 15), (-3, 2), (2, 9), (8, 15), (-4, -1)):
        got = gather_rows(shards, 11, lo, hi, mode, torch.device("cpu"))
        torch.testing.assert_close(got, want[:, lo + 4:hi + 4], rtol=0, atol=0)


def test_data_space_grads_match_jax_one_device():
    """2 ranks x 2 shards against one JAX device, on the JAX test's batch."""
    arch = "c3s1-4,d8,R8,U2,c3s1-3"
    spec, _ = parse_both(arch, in_channels=7)
    params = numpy_params(spec, 0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 16, 7)).astype(np.float32)
    t = rng.normal(size=(4, 32, 16, 3)).astype(np.float32)

    def loss_fn(p, a, b):
        return losses.pixel_loss("L2", jsty.apply(p, spec, a), b)

    l1, g1 = jax.jit(jax.value_and_grad(loss_fn))(params, x, t)
    got = mesh.spawn_ranks(ranks.grad_step, 2, arch, jax.tree_util.tree_map(np.asarray, params),
                           x, t, 2, backend="gloo", threads=1)
    (loss, grads), _ = got
    np.testing.assert_allclose(loss, float(l1), rtol=1e-5)
    assert_grads_close(grads, g1, rtol=2e-4, atol=2e-3)
