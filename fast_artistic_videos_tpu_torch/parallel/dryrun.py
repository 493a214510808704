"""The multi-device dry run — counterpart of the JAX package's
``__graft_entry__.py`` ``dryrun_multichip``.

On n devices (ranks of gloo processes over the CPU with ``device="cpu"``,
one NCCL process per card on the cards) it runs, on the tiny architecture
``c3s1-8,d16,R16,U2,c3s1-3``:

  * one data-parallel training step: the recurrent unrolled loss (frame 1
    by the model itself, two warped steps, perceptual + pixel + TV) and
    Adam, one row of the global batch per rank, the gradients averaged
    over the ranks;
  * a spatially sharded forward of one frame over the n devices
    (``parallel.spatial.SpatialStylizer``);
  * when n >= 4, the (data, space) forward: n // 2 ranks, each splitting
    its frame's height over two cards (``mesh.make_mesh_2d``);
  * the flow stage on device 1 and the stylizer on device 0 (the CLI's
    ``--flow_device``; device 0 for both when n is 1).

It checks finiteness and placement, and prints one summary line.

  python -c "from fast_artistic_videos_tpu_torch.parallel.dryrun import \\
      dryrun_multichip; dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import device as device_mod
from . import mesh

ARCH = "c3s1-8,d16,R16,U2,c3s1-3"
HW = 16


def _tiny():
    """The tiny stylizer and its parameters (seed 0) on the CPU."""
    from ..models import arch_dsl, stylizer

    spec = arch_dsl.parse_arch(ARCH, in_channels=7)
    return spec, stylizer.init_params(torch.Generator().manual_seed(0), spec, "cpu")


def _dp_step(device: str):
    """One rank of the data-parallel step; returns (mean loss, params
    identical to rank 0's)."""
    from ..models import stylizer, vgg
    from ..ops import filters, tv, warp
    from ..models.stylizer import leaves
    from ..train import losses

    dev = mesh.rank_device(device)
    spec, params = _tiny()
    params = stylizer.to_device(params, dev)
    mesh.broadcast_params(leaves(params))
    for t in leaves(params):
        t.requires_grad_(True)
    vgg_params = vgg.init_params(torch.Generator().manual_seed(1), dev)
    cfg = losses.PerceptualConfig(style_layers=(4,), style_weights=(10.0,),
                                  content_layers=(4,), content_weights=(1.0,))
    opt = torch.optim.Adam(leaves(params), lr=1e-3)

    n, h, w = mesh.world(), HW, HW
    rng = np.random.default_rng(0)      # the global batch, the same on every rank
    host = [rng.normal(size=(3, n, h, w, 3)), rng.normal(size=(2, n, h, w, 2)),
            rng.random((2, n, h, w, 1)), rng.normal(size=(1, h, w, 3))]
    imgs, flows, certs, style = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in host)
    imgs, flows, certs = (mesh.local_rows(t.transpose(0, 1)).transpose(0, 1)
                          for t in (imgs, flows, certs))
    nl = imgs.shape[1]
    with device_mod.float32_convs():
        style_tgts = losses.style_targets(vgg_params, style, cfg)
        c = [filters.min_filter(x, 3) for x in certs]
        with torch.no_grad():
            out1 = stylizer.apply(params, spec, torch.cat(
                [imgs[0], imgs.new_zeros((nl, h, w, 4))], dim=-1))
        out2 = warped = None
        for i in range(2):
            if out2 is not None:
                out1 = out2.detach()
            warped = warp.bilinear_warp(out1, flows[i]) * c[i]
            out2 = stylizer.apply(params, spec, torch.cat([imgs[i + 1], warped, c[i]], -1),
                                  fused=False)
        ploss, _ = losses.perceptual_loss(vgg_params, out2, imgs[2], style_tgts, cfg)
        loss = (ploss + 50.0 * losses.pixel_loss("L2", out2 * c[-1], warped.detach())
                + tv.tv_loss(out2, 1e-6) / nl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        mesh.all_reduce_grads(leaves(params))
        opt.step()
    flat = torch.cat([t.detach().reshape(-1) for t in leaves(params)])
    ref = flat.clone()
    if mesh.world() > 1:
        torch.distributed.broadcast(ref, src=0)
    same = bool(torch.equal(flat, ref))
    finite = bool(torch.isfinite(flat).all())
    on_dev = all(t.device == dev for t in leaves(params))
    return float(mesh.mean_over_ranks(loss.detach())), same and finite and on_dev


def _space_forward(device: str):
    """One rank of the (data, space) forward: its row of the global batch,
    height-split over its two devices. Returns (shape, finite, placed)."""
    from .spatial import SpatialStylizer

    m = mesh.make_mesh_2d(mesh.world(), 2, device)
    spec, params = _tiny()
    x = mesh.local_rows(torch.from_numpy(
        np.random.default_rng(1).normal(size=(m.data, HW, HW, 7)).astype(np.float32)))
    sp = SpatialStylizer(spec, params, devices=m.devices)
    shards = sp.shards(x)
    placed = all(t.device == d for (_, _, t), d in zip(shards, m.devices))
    out = torch.cat([t.to(m.devices[0]) for _, _, t in shards], dim=1)
    return tuple(out.shape), bool(torch.isfinite(out).all()), placed


def _devices(n: int, device: str):
    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        return [dev] * n
    if n > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n}): only {torch.cuda.device_count()} cards")
    return [torch.device("cuda", i) for i in range(n)]


def dryrun_multichip(n: int, device: str = device_mod.DEFAULT, timeout: float = 600.0):
    """The dry run on n devices (see the module docstring). Raises on any
    failed check; returns the figures it printed."""
    from ..flow import estimator as fest
    from ..flow.provider import StreamingFlowProvider
    from ..models import stylizer
    from ..video.engine import EngineConfig, StylizerEngine
    from .spatial import SpatialStylizer

    devs = _devices(n, device)
    backend = "nccl" if devs[0].type == "cuda" else "gloo"
    ranks = mesh.spawn_ranks(_dp_step, n, device, backend=backend, timeout=timeout)
    loss = ranks[0][0]
    if not (np.isfinite(loss) and all(ok for _, ok in ranks)):
        raise AssertionError(f"data-parallel step: {ranks}")

    # spatial: one frame split over the n devices
    spec, params = _tiny()
    rng = np.random.default_rng(2)
    frame = torch.from_numpy(rng.random((1, 8 * n, HW, 7)).astype(np.float32))
    shards = SpatialStylizer(spec, params, devices=devs).shards(frame)
    sp_shape = (1, sum(b - a for a, b, _ in shards), shards[0][2].shape[2], 3)
    if (sp_shape != (1, 8 * n, HW, 3) or any(t.device != d for (_, _, t), d in zip(shards, devs))
            or not all(bool(torch.isfinite(t).all()) for _, _, t in shards)):
        raise AssertionError(f"spatial forward: {sp_shape}, {[t.device for *_, t in shards]}")

    # (data, space): n // 2 ranks of two devices each
    two_d = None
    if n >= 4:
        two_d = mesh.spawn_ranks(_space_forward, n // 2, device, backend=backend,
                                 timeout=timeout)
        if not all(r == ((1, HW, HW, 3), True, True) for r in two_d):
            raise AssertionError(f"(data, space) forward: {two_d}")

    # flow on device 1, stylization on device 0
    d0, d1 = devs[0], devs[min(1, n - 1)]
    fparams = fest.init_params(torch.Generator().manual_seed(2), device=d1)
    prov = StreamingFlowProvider(fparams, device=d1)
    eng = StylizerEngine(lambda p, x: stylizer.apply(p, spec, x),
                         stylizer.to_device(params, d0), stride_multiple=spec.total_stride,
                         config=EngineConfig(), device=d0)
    prev = None
    for _ in range(3):
        f = torch.from_numpy(rng.random((32, 32, 3)).astype(np.float32))
        fc = prov(f.to(d1))
        if fc is None:
            prev = eng.stylize_first(f.to(d0))
        else:
            flow, cert = fc
            if flow.device != d1 or cert.device != d1:
                raise AssertionError(f"flow stage on {flow.device}, want {d1}")
            prev = eng.stylize_next(f.to(d0), prev, flow.to(d0), cert.to(d0), prov.last_band)
        if prev.device != d0:
            raise AssertionError(f"stylizer output on {prev.device}, want {d0}")
    if not bool(torch.isfinite(prev).all()):
        raise AssertionError("pipelined output is not finite")

    line = (f"dryrun_multichip({n}): ok, dp loss={loss:.4f}, sp out shape={sp_shape}, "
            + (f"(data, space) {n // 2}x2 out shape={two_d[0][0]}, " if two_d else "")
            + f"pp flow@{d1}/stylize@{d0} ok")
    print(line)
    return {"loss": loss, "sp_shape": sp_shape, "two_d": two_d, "line": line}
