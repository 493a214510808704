"""Process groups and data-parallel helpers on ``torch.distributed`` —
counterpart of ``fast_artistic_videos_tpu/parallel/mesh.py``.

The JAX package expresses data parallelism as one program over a device
mesh, and XLA inserts the gradient reduction. The port runs one process
per card (the CPU tests: one gloo process per rank): every rank holds the
whole model, loads only its rows of the global batch, and averages its
gradients with the others' before the optimizer step. The (data, space)
layout of :func:`make_mesh_2d` adds height sharding over each rank's own
devices (``parallel.spatial``).

Without an initialized process group every helper acts as a world of one.
``prime_collectives`` is not ported: it works around XLA's gloo clique
deadline, which ``torch.distributed`` does not have.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import device as device_mod


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def init_process_group(backend: Optional[str] = None, init_method: Optional[str] = None,
                       world_size: Optional[int] = None, rank: Optional[int] = None) -> str:
    """Join the process group: NCCL when a card is present, gloo otherwise
    (or as `backend` says). The address, world size and rank come from the
    arguments, else from the usual RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT environment (``torchrun`` sets them). Under NCCL the rank's
    card (rank % cards) is made current. Returns the backend."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return backend


def rank_device(device=device_mod.DEFAULT) -> torch.device:
    """This rank's device: under NCCL, card rank % cards (one process per
    card); otherwise `device` as given ("cpu", or a card that several
    gloo ranks share)."""
    dev = device_mod.resolve(device)
    if (dev.type == "cuda" and dev.index is None and initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return dev


def local_rows(batch):
    """This rank's contiguous rows of a global batch (an array or tensor
    with the batch first, or a list / tuple / dict of them): rows
    [r n / w, (r + 1) n / w) of n — the counterpart of
    ``put_global_batch``, where every process passes its own rows."""
    if isinstance(batch, dict):
        return {k: local_rows(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_rows(v) for v in batch)
    n, w, r = batch.shape[0], world(), rank()
    if n % w:
        raise ValueError(f"global batch {n} not divisible by the world size {w}")
    return batch[r * n // w:(r + 1) * n // w]


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """Indices of `tensors` grouped by (device, dtype), in order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return groups.values()


def broadcast_params(ts: Sequence[torch.Tensor]) -> None:
    """Overwrite every tensor of `ts` (a parameter tree's leaves) with rank
    0's, in place: one flat broadcast per device and dtype."""
    if world() == 1:
        return
    with torch.no_grad():
        for idx in _flat_groups(ts):
            flat = torch.cat([ts[i].detach().reshape(-1) for i in idx])
            dist.broadcast(flat, src=0)
            off = 0
            for i in idx:
                n = ts[i].numel()
                ts[i].copy_(flat[off:off + n].view_as(ts[i]))
                off += n


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Average the gradients of `params` over the ranks, in place: one
    all-reduce of one flat contiguous buffer per device and dtype, not one
    call per leaf. A leaf without a gradient contributes zeros (and gets
    them), so every rank reduces the same buffer."""
    if world() == 1:
        return
    w = world()
    with torch.no_grad():
        for idx in _flat_groups(params):
            grads = [params[i].grad if params[i].grad is not None
                     else torch.zeros_like(params[i]) for i in idx]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= w
            off = 0
            for i, g in zip(idx, grads):
                n = g.numel()
                params[i].grad = flat[off:off + n].view_as(params[i])
                off += n


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The element-wise mean of `t` over the ranks (a new tensor; `t`
    itself when the world is one)."""
    if world() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / world()


def barrier() -> None:
    if world() > 1:
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (data, space) layout: `data` ranks (the process group) split the
    batch, and each rank splits the frame height over its `space` devices
    (``parallel.spatial.SpatialStylizer``); gradients are averaged over
    the ranks and summed over each rank's shards by autograd. The JAX
    package's ``make_mesh_2d``."""

    data: int
    space: int
    devices: Tuple[torch.device, ...]   # this rank's space devices


def make_mesh_2d(data: int, space: int, device=device_mod.DEFAULT) -> Mesh2D:
    """This rank's place in a (data, space) layout. `data` must equal the
    world size. On the cards rank r takes cards r * space .. r * space +
    space - 1 (raising when there are fewer than data * space); on the
    CPU every shard is "cpu"."""
    if data != world():
        raise ValueError(f"data axis {data} != world size {world()} (one process per "
                         f"data shard)")
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if data * space > n:
            raise ValueError(f"requested {data}x{space} cards, have {n}")
        devs = tuple(torch.device("cuda", rank() * space + j) for j in range(space))
    else:
        devs = (dev,) * space
    return Mesh2D(data, space, devs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank_, world_size, init_method, backend, threads, results, args):
    """A spawned rank: join the group, run fn(*args), report (rank,
    result, traceback) on the results queue, leave the group."""
    if threads:
        torch.set_num_threads(threads)
    try:
        init_process_group(backend, init_method, world_size, rank_)
        results.put((rank_, fn(*args), None))
    except BaseException:
        results.put((rank_, None, traceback.format_exc()))
        raise
    finally:
        if initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
                timeout: float = 600.0, threads: Optional[int] = None) -> List:
    """Run fn(*args) in `world_size` new processes (the ``spawn`` start
    method), one rank each of a process group on a localhost TCP address
    (`backend` as :func:`init_process_group` picks it). Returns the ranks'
    results in rank order; raises with the first failing rank's traceback,
    or after `timeout` seconds, and stops every process it started. fn
    must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init_method, backend, threads, results, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, err = [None] * world_size, None
    try:
        for _ in range(world_size):
            r, res, tb = results.get(timeout=timeout)
            if tb is not None:
                err = err or f"rank {r} failed:\n{tb}"
                break
            out[r] = res
        if err is None:
            for p in procs:
                p.join(timeout=timeout)
    except queue.Empty:
        err = f"ranks did not finish within {timeout} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    if err is not None:
        raise RuntimeError(err)
    return out
