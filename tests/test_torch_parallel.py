"""The port's data-parallel layer (fast_artistic_videos_tpu_torch.parallel:
mesh, dryrun; train.trainer under a process group) on the CPU, in spawned
gloo processes (two ranks where the JAX tests use eight devices):

  * the gradients of two ranks against the JAX package's 8-device
    ``grad_fn`` (tests/test_parallel.py:20): loss rtol 1e-5, gradients
    rtol 2e-4, atol 1e-4;
  * a two-process trainer: the JAX trainer's multi-process contract
    (global batch, shards, rank-0 writes, per-rank sidecars), and the
    elastic drill: a world-2 run restored at its checkpoint continues bit
    for bit, and the same checkpoint restored onto a world of one trains
    on within a calibrated distance of the world-2 run, which two planted
    faults miss;
  * the uniform-random occlusion fill of two ranks against a world of one
    on the same global batch;
  * ``dryrun_multichip(2)`` in gloo processes.
"""

import importlib.util
import json
import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from fast_artistic_videos_tpu.models import arch_dsl, stylizer
from fast_artistic_videos_tpu.parallel import mesh as jmesh
from fast_artistic_videos_tpu.train import losses
from fast_artistic_videos_tpu_torch.models import arch_dsl as tarch
from fast_artistic_videos_tpu_torch.parallel import mesh
from fast_artistic_videos_tpu_torch.parallel.dryrun import dryrun_multichip

ARCH = "c3s1-4,d8,R8,U2,c3s1-3"
THREADS = 1      # torch threads per spawned rank (the suite runs 6 workers)


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def jax_grads(params, spec, x, t, devices):
    """Loss and gradients of the JAX test's pixel loss, batch sharded over
    `devices` of the virtual CPU mesh (1: one device)."""
    def loss_fn(p, a, b):
        return losses.pixel_loss("L2", stylizer.apply(p, spec, a), b)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    if devices == 1:
        return grad_fn(params, jnp.asarray(x), jnp.asarray(t))
    m = jmesh.make_mesh(devices)
    return grad_fn(jmesh.replicate(m, params), jmesh.shard_batch(m, jnp.asarray(x)),
                   jmesh.shard_batch(m, jnp.asarray(t)))


def assert_grads_close(port, want, rtol, atol):
    port, want = _flat(port), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(port[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_local_rows_and_world_of_one():
    """Without a process group every helper is a world of one."""
    a = np.arange(24).reshape(8, 3)
    assert (mesh.world(), mesh.rank()) == (1, 0)
    np.testing.assert_array_equal(mesh.local_rows(a), a)
    t = torch.ones(3)
    assert mesh.mean_over_ranks(t) is t
    p = torch.ones(2, requires_grad=True)
    p.grad = torch.full((2,), 3.0)
    mesh.all_reduce_grads([p])
    assert p.grad.tolist() == [3.0, 3.0]


ITERS, CKPT = 4, 2      # the drill: checkpoints at 2 and 4, a run lost after 3
BATCH = np.arange(8 * 2).reshape(8, 2)
# The restore onto a world of one against the world-2 run, over iterations
# 3-4 (see drill_gap). The two runs see the same global batches (see
# coco), so they differ by float rounding alone: measured here (CPU, one
# torch thread) losses 1.9e-7, leaves 1.5e-6; the planted faults (Adam
# afresh, rank 1's sidecar) losses 8.2e-3 and 1.5e-2, leaves 1.56 and
# 0.57. The limits stand about 10x above the true restore and more than
# 4000x below the faults.
DRILL_LIMITS = {"loss": 2e-6, "leaf": 2e-5}
DRILL_CANCELLED_ABS = 2 * 1e-3 * (ITERS - CKPT)   # Adam: at most 2 lr a step


def cancelled_biases(spec):
    """chip_smoke.py's keys of the biases an instance norm cancels."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sp = importlib.util.spec_from_file_location("chip_smoke",
                                                os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.cancelled_biases(spec)


def drill_gap(p, h, p_ref, h_ref, p_ck, cancelled):
    """How far a restored run (parameters p, history h) strays from the
    uninterrupted world-2 run's after the checkpoint (p_ck: the
    parameters there), as chip_smoke.py's resume_gap measures it: the
    losses' largest relative gap over iterations 3-4, each leaf's L2
    distance relative to the world-2 run's update of it since the
    checkpoint (the cancelled biases apart), and the cancelled biases'
    largest element gap."""
    loss = max(abs(x - y) / abs(y) for x, y in zip(h[CKPT:], h_ref[CKPT:]))
    leaf, noise = 0.0, 0.0
    p = _flat(p)
    for k, v in _flat(p_ref).items():
        d = p[k].astype(np.float64) - v
        if k in cancelled:
            noise = max(noise, float(np.abs(d).max()))
        else:
            leaf = max(leaf, float(np.linalg.norm(d) / np.linalg.norm(v - p_ck[k])))
    return {"loss": loss, "leaf": leaf, "cancelled_abs": noise}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """16 train images, 8 a shard at world 2. Images 8-11 repeat 4-7, so
    that after the iteration-2 checkpoint a world of one restored from
    rank 0's sidecar (cursor 0, 8 rows a batch: images 0-7, then 8-15)
    sees the same global batches as the world-2 run (images 0-3 and 8-11,
    then 4-7 and 12-15)."""
    path = str(tmp_path_factory.mktemp("dp") / "coco.h5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for split in ("train2014", "val2014"):
            imgs = rng.integers(0, 256, (16, 3, 32, 32), dtype=np.uint8)
            if split == "train2014":
                imgs[8:12] = imgs[4:8]
            f.create_dataset(f"/{split}/images", data=imgs)
    return path


def _opts(coco, name):
    return dict(arch=ARCH, h5_file=coco, data_mix="shift:1,zoom_out:1",
                train_img_size="32:32", batch_size=8, percep_loss_weight=0.0,
                loss_network="rgb-pyramid", images_every=0, print_every=10 ** 9,
                history_every=1, checkpoint_every=CKPT, checkpoint_name=name)


@pytest.fixture(scope="module")
def grad_case():
    """The JAX test's batch and parameters (tests/test_parallel.py:20)."""
    rng = np.random.default_rng(0)
    spec = arch_dsl.parse_arch(ARCH, in_channels=7)
    params = stylizer.init_params(jax.random.PRNGKey(0), spec)
    x = rng.normal(size=(8, 16, 16, 7)).astype(np.float32)
    t = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    return spec, params, x, t


@pytest.fixture(scope="module")
def noise_case(coco):
    """Options with the uniform-random occlusion fill and a global batch
    of 8 (two steps, random certainties half occluded)."""
    rng = np.random.default_rng(5)
    opts = dict(_opts(coco, "unused"), fill_occlusions="uniform-random")
    imgs = [rng.normal(0, 40, (8, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    flows = [rng.normal(0, 2, (8, 16, 16, 2)).astype(np.float32) for _ in range(2)]
    certs = [(rng.random((8, 16, 16, 1)) < 0.5).astype(np.float32) for _ in range(2)]
    return opts, imgs, flows, certs


@pytest.fixture(scope="module")
def two_ranks(coco, grad_case, noise_case, tmp_path_factory):
    """Every two-rank job of this module in one spawned gloo world (each
    spawn costs an interpreter and a torch import a rank): the rank's rows,
    the gradient step, the refused batch, the trainer drill (the
    uninterrupted run, the run lost after iteration 3, the restore of its
    iteration-2 checkpoint), the CLI and the uniform-random fill's
    gradient. Returns (rank 0's results, rank
    1's, the work directory)."""
    d = tmp_path_factory.mktemp("ranks")
    _, params, x, t = grad_case
    ref, fail, resumed = (str(d / n) for n in ("ref", "fail", "resumed"))
    jobs = [("rows", BATCH),
            ("grads", ARCH, jax.tree_util.tree_map(np.asarray, params), x, t),
            ("refused", dict(arch=ARCH, batch_size=3)),
            ("train", _opts(coco, ref), ITERS),
            ("train", _opts(coco, fail), ITERS - 1),
            ("train", _opts(coco, resumed), ITERS, fail + "_state"),
            ("cli", ["--arch", ARCH, "--h5_file", coco, "--data_mix", "shift:1",
                     "--train_img_size", "32:32", "--batch_size", "4",
                     "--num_data_devices", "2", "--percep_loss_weight", "0",
                     "--loss_network", "rgb-pyramid", "--num_iterations", "2",
                     "--checkpoint_every", "2", "--images_every", "0",
                     "--checkpoint_name", str(d / "cli" / "c"), "--device", "cpu"]),
            ("loss_grads",) + noise_case]
    r0, r1 = mesh.spawn_ranks(ranks.run_jobs, 2, jobs, backend="gloo", threads=THREADS)
    return r0, r1, d


def test_local_rows_in_two_ranks(two_ranks):
    """Each rank keeps its contiguous half of the global batch; the group
    is the world the helpers see."""
    r0, r1, _ = two_ranks
    assert [r0[0][:2], r1[0][:2]] == [(0, 2), (1, 2)]
    np.testing.assert_array_equal(np.concatenate([r0[0][2], r1[0][2]]), BATCH)
    np.testing.assert_array_equal(r1[0][2], BATCH[4:])


def test_data_parallel_grads_match_jax_8_devices(two_ranks, grad_case):
    """Same global batch: two gloo ranks of the port (4 rows each, the
    gradients averaged through one flat all-reduce) against the JAX
    package's 8-device data-parallel grad_fn and its one-device run."""
    spec, params, x, t = grad_case
    l8, g8 = jax_grads(params, spec, x, t, 8)
    l1, _ = jax_grads(params, spec, x, t, 1)
    np.testing.assert_allclose(float(l1), float(l8), rtol=1e-5)
    (loss0, g0), (loss1, g1) = two_ranks[0][1], two_ranks[1][1]
    assert loss0 == loss1
    for k, v in _flat(g0).items():
        np.testing.assert_array_equal(v, _flat(g1)[k])     # one all-reduce, same result
    np.testing.assert_allclose(loss0, float(l8), rtol=1e-5)
    assert_grads_close(g0, g8, rtol=2e-4, atol=1e-4)


def test_uniform_random_fill_matches_world_one(two_ranks, noise_case):
    """--fill_occlusions uniform-random: two ranks draw the global batch's
    noise from generators in step and keep their own rows, so their loss
    and averaged gradients are those of one process on the whole batch
    (the JAX trainer draws one noise array over the global batch)."""
    opts, imgs, flows, certs = noise_case
    (l0, g0, s0), (l1, g1, s1) = two_ranks[0][7], two_ranks[1][7]
    l, g, s = ranks.loss_grads(opts, imgs, flows, certs)
    assert l0 == l1
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(s0, s)
    np.testing.assert_allclose(l0, l, rtol=1e-5)
    assert_grads_close(g0, g, rtol=2e-4, atol=1e-4)


def test_trainer_refuses_a_world_that_does_not_match(two_ranks):
    """num_data_devices > 1 needs a process group, and the global batch
    must split evenly over the world."""
    from fast_artistic_videos_tpu_torch.core.config import TrainOptions
    from fast_artistic_videos_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="one process per card"):
        Trainer(TrainOptions(arch=ARCH, num_data_devices=2), device="cpu")
    assert "not divisible by the world size 2" in two_ranks[0][2]


def test_two_process_trainer_and_elastic_drill(two_ranks, coco):
    """A world-2 trainer (global batch 8: 4 rows a rank from its shard of
    the images) checkpoints at iterations 2 and 4. Rank 0 alone writes the
    history and the model; each rank writes its sidecar. A world-2 run
    that dies after iteration 3 and restores the iteration-2 checkpoint
    ends at 4 bit-identical to the uninterrupted run, its history
    included; the same checkpoint restored onto a world of one (the whole
    dataset, rank 0's sidecar) trains on to 4 within DRILL_LIMITS of it,
    and two planted faults miss them."""
    r0, r1, d = two_ranks
    (p_ref, h_ref, same), (_, h_ref1, _) = r0[3], r1[3]
    p_res, h_res, same_res = r0[5]
    assert same and same_res and h_ref == h_ref1 and len(h_ref) == ITERS
    assert all(np.isfinite(h_ref))
    files = sorted(f for f in os.listdir(d) if f.startswith("ref"))
    assert files == ["ref.json", "ref_1.npz", "ref_state.pt", "ref_state.rng.json",
                     "ref_state.rng.p1.json"], files
    with open(d / "ref.json") as f:
        assert json.load(f)["train_loss_history"] == h_ref
    with open(d / "ref_state.rng.json") as f0, open(d / "ref_state.rng.p1.json") as f1:
        s0, s1 = json.load(f0), json.load(f1)
    assert s0["rng_state"] == s1["rng_state"]                 # the same draws on every rank
    assert s0["image_cursor"] != s1["image_cursor"]           # each its own shard
    with open(d / "fail.json") as f:
        assert json.load(f)["iter"] == CKPT                   # iteration 3 was lost
    assert h_res == h_ref
    for k, v in _flat(p_ref).items():
        np.testing.assert_array_equal(_flat(p_res)[k], v, err_msg=k)

    # onto a world of one: rank 0's sidecar, the whole dataset, which the
    # fixture's repeated images make the world-2 run's global batches
    fail = str(d / "fail") + "_state"
    p_ck = _flat(ranks.train(_opts(coco, str(d / "ck")), CKPT, fail)[0])
    cancelled = cancelled_biases(tarch.parse_arch(ARCH, in_channels=7))
    p_one, h_one, _ = ranks.train(_opts(coco, str(d / "one")), ITERS, fail)
    assert len(h_one) == ITERS and h_one[:CKPT] == h_ref[:CKPT]
    gap = drill_gap(p_one, h_one, p_ref, h_ref, p_ck, cancelled)
    assert gap["loss"] <= DRILL_LIMITS["loss"] and gap["leaf"] <= DRILL_LIMITS["leaf"], gap
    assert gap["cancelled_abs"] <= DRILL_CANCELLED_ABS, gap

    # planted faults: Adam started afresh; rank 1's sidecar (its cursor is
    # in the second shard) taken for rank 0's
    p_fresh, h_fresh, _ = ranks.train(_opts(coco, str(d / "fresh")), ITERS, fail,
                                      fresh_optimizer=True)
    shutil.copy(fail + ".pt", str(d / "swap_state.pt"))
    shutil.copy(fail + ".rng.p1.json", str(d / "swap_state.rng.json"))
    shutil.copy(str(d / "fail.json"), str(d / "swap.json"))
    p_swap, h_swap, _ = ranks.train(_opts(coco, str(d / "swap")), ITERS,
                                    str(d / "swap_state"))
    for name, p, h in (("fresh optimizer", p_fresh, h_fresh),
                       ("rank 1's sidecar", p_swap, h_swap)):
        g = drill_gap(p, h, p_ref, h_ref, p_ck, cancelled)
        assert g["loss"] > DRILL_LIMITS["loss"] or g["leaf"] > DRILL_LIMITS["leaf"], (name, g)


def test_train_cli_in_two_ranks(two_ranks):
    """cli.train with --num_data_devices 2 in two gloo ranks (torchrun's
    layout on the CPU): one history and model from rank 0, a sidecar a
    rank."""
    r0, r1, d = two_ranks
    assert r0[6] == r1[6] == 0
    assert sorted(os.listdir(d / "cli")) == ["c.json", "c_1.npz", "c_state.pt",
                                             "c_state.rng.json", "c_state.rng.p1.json"]
    with open(d / "cli" / "c.json") as f:
        assert json.load(f)["iter"] == 2


def test_dryrun_multichip_two_gloo_ranks(capsys):
    """The multi-device dry run on two CPU ranks: the data-parallel step,
    the spatial forward over two shards, flow and stylizer pinned."""
    out = dryrun_multichip(2, device="cpu")
    assert np.isfinite(out["loss"]) and out["sp_shape"] == (1, 16, 16, 3)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
