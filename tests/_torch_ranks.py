"""Rank bodies for the port's multi-process CPU tests (test_torch_parallel.py,
test_torch_spatial.py): each runs in a spawned gloo process
(``parallel.mesh.spawn_ranks``), so this module imports torch, numpy and
the port only, never JAX."""

import numpy as np
import torch

from fast_artistic_videos_tpu_torch.core.config import TrainOptions
from fast_artistic_videos_tpu_torch.models import arch_dsl, checkpoint, stylizer
from fast_artistic_videos_tpu_torch.parallel import mesh
from fast_artistic_videos_tpu_torch.parallel.spatial import SpatialStylizer
from fast_artistic_videos_tpu_torch.train import losses
from fast_artistic_videos_tpu_torch.train.trainer import Trainer, leaves


def grad_step(arch, params_np, x, target, space=1):
    """The L2 pixel loss of the stylizer on this rank's rows of (x,
    target), its gradients averaged over the ranks; with space > 1 each
    rank splits the height over `space` CPU shards (the (data, space)
    layout). Returns (global loss, gradient tree in the JAX layout) from
    every rank."""
    spec = arch_dsl.parse_arch(arch, in_channels=7)
    params = checkpoint.params_from_numpy(params_np, device="cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    xl, tl = (torch.from_numpy(mesh.local_rows(a)) for a in (x, target))
    if space > 1:
        m = mesh.make_mesh_2d(mesh.world(), space, "cpu")
        out = SpatialStylizer(spec, params, devices=m.devices)(xl)
    else:
        out = stylizer.apply(params, spec, xl, fused=False)
    loss = losses.pixel_loss("L2", out, tl)
    loss.backward()
    mesh.all_reduce_grads(leaves(params))
    return (float(mesh.mean_over_ranks(loss.detach())),
            checkpoint.params_to_numpy(_grad_tree(params)))


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def train(opt_kw, iterations, restore=None, fresh_optimizer=False):
    """A CPU trainer of this rank (num_data_devices = the world size),
    optionally restored from `restore` (with fresh_optimizer, Adam then
    starts afresh: a planted fault), trained to `iterations`. Returns
    (parameters in the JAX layout, train loss history, whether every
    rank's parameters equal rank 0's)."""
    tr = Trainer(TrainOptions(num_data_devices=mesh.world(), **opt_kw), device="cpu")
    if restore:
        tr.restore_train_state(restore)
    if fresh_optimizer:
        tr.optimizer = tr._make_optimizer()
    tr.train(iterations, log_fn=lambda *a: None)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves(tr.params)])
    ref = flat.clone()
    if mesh.world() > 1:
        torch.distributed.broadcast(ref, src=0)
    same = mesh.mean_over_ranks(torch.tensor(float(torch.equal(flat, ref))))
    return (checkpoint.params_to_numpy(tr.params), list(tr.train_loss_history),
            float(same) == 1.0)


def loss_grads(opt_kw, imgs, flows, certs):
    """The trainer's loss (first frame "self") on this rank's rows of a
    global batch (lists of numpy arrays: num_steps + 1 frames, num_steps
    flows and certainties), its gradients averaged over the ranks. Returns
    (global loss, gradient tree in the JAX layout, the trainer's
    generator state after the draws)."""
    tr = Trainer(TrainOptions(num_data_devices=mesh.world(), **opt_kw), device="cpu")
    batch = [[torch.from_numpy(mesh.local_rows(a)) for a in arrays]
             for arrays in (imgs, flows, certs)]
    loss, _ = tr._loss_fn(tr.params, *batch, len(flows), "self")
    tr._backward(loss)
    mesh.all_reduce_grads(leaves(tr.params))
    return (float(mesh.mean_over_ranks(loss.detach())),
            checkpoint.params_to_numpy(_grad_tree(tr.params)),
            tr.generator.get_state().numpy())


def run_jobs(jobs):
    """The jobs of one test module in one spawned world, in order: a list
    of (name, *args) with name "rows" (:func:`rank_rows`), "grads"
    (:func:`grad_step`), "train" (:func:`train`), "loss_grads"
    (:func:`loss_grads`), "cli" (the training CLI with argv) or "refused"
    (the ValueError message of a trainer built with these options, before
    any collective). Returns {index: result}."""
    from fast_artistic_videos_tpu_torch.cli import train as tcli

    def refused(opt_kw):
        try:
            Trainer(TrainOptions(num_data_devices=mesh.world(), **opt_kw), device="cpu")
        except ValueError as e:
            return str(e)
        return None

    run = {"rows": rank_rows, "grads": grad_step, "train": train, "loss_grads": loss_grads,
           "cli": tcli.main, "refused": refused}
    return {i: run[name](*args) for i, (name, *args) in enumerate(jobs)}


def rank_rows(batch):
    """(rank, world, this rank's rows of `batch`) as this process sees them."""
    return mesh.rank(), mesh.world(), mesh.local_rows(np.asarray(batch))
