"""Training driver — counterpart of ``fast_artistic_videos_tpu/train/trainer.py``
(the reference's train_video.lua).

Semantics kept from the reference closure ``f`` (train_video.lua:245-379):
  * frame-1 stylization: zeros (single_image source), the model itself with
    a zero prior, or a finished image model; never on the gradient path;
  * per step: warp the previous output (the exact gather), mask it by the
    eroded certainty, fill the occlusions, stylize again;
  * gradients flow through the last unrolled step only (the reference calls
    model:backward once, :371-373); ``full_bptt`` lifts that;
  * loss = percep_weight * perceptual(out_last, content_last)
         + pixel_weight * pixel(out_last * cert, warped_prev * cert)
         + the TV term of the final output (the reference's in-model
           TotalVariation layer);
  * the data-mix wheel, the iteration-keyed frame-step and LR schedules,
    single_image_until, validation over every source, the debug dumps and
    the JSON history.

The reference reports the pixel loss times a shadowed zero
(train_video.lua:357); the true value is reported here, as in the JAX
package.

In the port:
  * the pass that carries the gradient runs the stylizer's plain path,
    ``stylizer.apply(..., fused=False)``: the kernels have no backward, and
    raise when handed a tensor that requires grad under grad mode
    (``ops._build.no_grad_inputs``). The forward-only passes (frame 1, the
    unrolled steps before the last unless ``full_bptt``, validation) run
    under ``torch.no_grad()`` on the default route: on the card that is
    K4 for every residual-block conv at batch > 1, K3 + K2 at batch 1;
  * the whole step, forward, backward and the optimizer, runs inside
    ``core.device.float32_convs``: float32 convs and products stay float32
    (TF32 off) in the backward too, which runs when ``loss.backward()`` is
    called;
  * Adam is ``torch.optim.Adam`` with the learning rate set per step. Its
    coupled ``weight_decay`` adds ``wd * param`` to the gradient before the
    moments, which is the JAX package's
    ``optax.chain(add_decayed_weights(wd), adam)``;
  * random numbers: the data RNG is ``np.random.default_rng(seed + 1)``, so
    one seed draws the JAX trainer's batches and wheel; one
    ``torch.Generator`` on the trainer's device, seeded with ``seed``,
    draws the initial parameters, a random VGG-16 when no loss network is
    given, and the ``uniform-random`` occlusion fill (the JAX package's
    ``self.key``);
  * checkpoints: ``<base>_state.pt`` (params, the optimizer's state dict,
    iteration; one ``torch.save``), ``<base>_state.rng.json`` (the PCG64
    state as decimal strings, the generator's state, the data cursors and
    the history accumulators), ``<base>.json`` (the history) and
    ``<base>_<steps>.npz`` (the model, in the JAX package's layout, which
    both packages' ``load_model`` read);
  * data parallel: one process per card under a ``torch.distributed``
    process group (``parallel.mesh.init_process_group``; NCCL on the cards,
    gloo on the CPU), ``num_data_devices`` equal to its world size. The JAX
    trainer's multi-process contract holds: ``batch_size`` is global and
    divisible by the world size, and each rank's sources serve its
    contiguous shard of the dataset, ``batch_size / world`` rows a batch;
    every rank seeds the same generators, so the data-mix wheel, the
    synthetic transforms, the vr source and validation draw the same
    numbers in the same order on every rank; parameters are broadcast from
    rank 0 after init and after ``set_params``; the gradients are averaged
    over the ranks (one all-reduce of a flat buffer) between the backward
    and the optimizer step; the logged train and validation losses are
    means over the ranks (each rank's loss is over its own rows, the TV
    term divided by the rank's own batch, so the mean over ranks is the
    global batch's loss). Rank 0 alone writes the history JSON, the
    ``.npz`` and ``<base>_state.pt``; every rank writes its RNG sidecar
    (``.rng.json`` on rank 0, ``.rng.p{i}.json`` on rank i), and a
    restore reads its own sidecar, else ``.rng.json``, so a checkpoint
    restores onto a smaller world. ``num_data_devices > 1`` without a
    process group raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import device as device_mod
from ..core import io as core_io
from ..core.config import (
    TrainOptions,
    data_mix_wheel,
    parse_data_mix,
    parse_iter_schedule,
    parse_layers,
    parse_lr_schedule,
    schedule_value,
)
from ..flow.estimator import resize_bilinear
from ..models import arch_dsl, checkpoint as model_ckpt, stylizer, vgg
from ..models.stylizer import leaves
from ..ops import filters, tv, warp
from ..parallel import mesh
from ..ops.preprocess import vgg_deprocess, vgg_preprocess
from . import data as data_mod
from . import data_vr, losses


def _detached(tree):
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


class Trainer:
    """Trains a video style model on `device` (the card unless
    ``device="cpu"``; under an NCCL process group, the rank's card), one
    rank of a data-parallel world when a process group is initialized.
    vgg_params: the loss network (``models.vgg`` tree on `device`), None
    for a random one. image_model: (spec, params) of a frame-1 image model,
    or None."""

    def __init__(self, opt: TrainOptions, vgg_params=None, image_model=None,
                 device=device_mod.DEFAULT):
        world = mesh.world()
        if not mesh.initialized() and opt.num_data_devices > 1:
            raise RuntimeError(
                f"num_data_devices {opt.num_data_devices}: data-parallel training runs one "
                f"process per card; launch {opt.num_data_devices} processes (torchrun, or "
                f"RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT) that each call "
                f"parallel.mesh.init_process_group() before building the trainer")
        if mesh.initialized() and opt.num_data_devices != world:
            raise ValueError(f"num_data_devices {opt.num_data_devices} != the process "
                             f"group's world size {world}")
        if opt.batch_size % world:
            raise ValueError(f"batch_size {opt.batch_size} not divisible by the world "
                             f"size {world}")
        self.opt = opt
        self.device = mesh.rank_device(device)
        self.spec = arch_dsl.parse_arch(
            opt.arch,
            in_channels=7,
            padding_type=opt.padding_type,
            use_instance_norm=opt.use_instance_norm,
            tanh_constant=opt.tanh_constant,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(opt.seed)

        # loss network
        style_layers, style_weights = parse_layers(opt.style_layers, opt.style_weights)
        content_layers, content_weights = parse_layers(opt.content_layers, opt.content_weights)
        self.percep_cfg = losses.PerceptualConfig(
            style_layers=tuple(int(l) for l in style_layers),
            style_weights=tuple(style_weights),
            content_layers=tuple(int(l) for l in content_layers),
            content_weights=tuple(content_weights),
            agg_type=opt.style_target_type,
            extractor="rgb-pyramid" if opt.loss_network == "rgb-pyramid" else "vgg",
        )
        if vgg_params is None and self.percep_cfg.extractor == "vgg":
            # no pretrained weights: random VGG taps (a weak but nonzero
            # style signal; --loss_network rgb-pyramid is the deterministic
            # in-tree loss)
            vgg_params = vgg.init_params(self.generator, self.device)
        self.vgg_params = vgg_params

        # style targets
        self.style_tgts: Optional[List[torch.Tensor]] = None
        if opt.style_image:
            style = _scale_shorter_side(core_io.load_image(opt.style_image),
                                        opt.style_image_size)
            pre = vgg_preprocess(torch.from_numpy(style).to(self.device))[None]
            with torch.no_grad(), device_mod.float32_convs():
                self.style_tgts = losses.style_targets(self.vgg_params, pre, self.percep_cfg)

        # image model for frame-1 stylization (None: the model itself)
        self.image_model = image_model

        self.params = stylizer.init_params(self.generator, self.spec, self.device)
        mesh.broadcast_params(leaves(self.params))
        for t in leaves(self.params):
            t.requires_grad_(True)
        self.lr_sched = parse_lr_schedule(opt.learning_rate)
        self.frame_steps_sched = parse_iter_schedule(opt.num_frame_steps)
        # the reference parses -weight_decay but comments its use out
        # (train_video.lua:376); it is applied here, as in the JAX package
        self.optimizer = self._make_optimizer()
        self.iteration = 0

        # data mix
        self.mix = parse_data_mix(opt.data_mix)
        self.wheel = data_mix_wheel(self.mix)
        h, w = (int(v) for v in opt.train_img_size.split(":"))
        self.train_hw = (h, w)
        # batch_size is global; each rank loads its own shard's rows
        local_bs = opt.batch_size // world
        shard_kw = dict(num_shards=world, shard_index=mesh.rank())
        self.image_source = (
            data_mod.H5ImageSource(opt.h5_file, local_bs, out_hw=(h, w),
                                   max_train=opt.max_train, **shard_kw)
            if opt.h5_file else None)
        self.video_source = (
            data_mod.H5VideoSource(opt.h5_file_video, local_bs,
                                   max_train=opt.max_train, **shard_kw)
            if opt.h5_file_video else None)
        self.data_rng = np.random.default_rng(opt.seed + 1)
        self._vr_maps = data_vr.VRMaps()

        # histories (train_video.lua:382-394)
        self.train_loss_history: List[float] = []
        self.val_loss_history: List[float] = []
        self.val_loss_last_history: List[float] = []
        self.val_loss_history_ts: List[int] = []
        self.percept_loss_history: Dict[str, List[float]] = {}
        self._loss_accum: Dict[str, float] = {}
        self._total_accum = 0.0

        self._dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32

    def _make_optimizer(self):
        return torch.optim.Adam(leaves(self.params), lr=self.lr_sched[0][1],
                                weight_decay=self.opt.weight_decay)

    def set_params(self, tree) -> None:
        """Overwrite the parameters with a numpy tree in the JAX package's
        layout (HWIO kernels) and start the optimizer afresh."""
        src = model_ckpt.params_from_numpy(tree, self.device)

        def copy(dst, src):
            if dst.keys() != src.keys():
                raise ValueError(f"set_params: keys {sorted(src)} != {sorted(dst)}")
            for k, d in dst.items():
                if isinstance(d, dict):
                    copy(d, src[k])
                elif d.shape != src[k].shape:
                    raise ValueError(f"set_params: {k} {tuple(src[k].shape)} != "
                                     f"{tuple(d.shape)}")
                else:
                    d.copy_(src[k])

        with torch.no_grad():
            copy(self.params, src)
        mesh.broadcast_params(leaves(self.params))
        self.optimizer = self._make_optimizer()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _model(self, params, x, grad: bool):
        """The stylizer on x (N, H, W, 7), VGG space; float32 out. The pass
        that carries the gradient takes the plain path (fused=False); a
        forward-only pass runs under no_grad on the default route (the
        kernels on the card)."""
        if grad:
            return stylizer.apply(params, self.spec, x, dtype=self._dtype, fused=False).float()
        with torch.no_grad():
            return stylizer.apply(params, self.spec, x, dtype=self._dtype).float()

    def _loss_fn(self, params, imgs, flows, certs, num_steps: int, first_mode: str,
                 all_steps: bool = False):
        """imgs: num_steps+1 (N, H, W, 3) VGG-space tensors (the vr
        source's frame 1 is a border strip of another shape); flows:
        num_steps (N, Hf, Wf, 2); certs: num_steps (N, Hf, Wf, 1). Returns
        (total, (aux, out_last, warped_prev_masked)). The reference closure
        f (:245-379)."""
        opt = self.opt
        n, h, w = imgs[-1].shape[0], imgs[-1].shape[1], imgs[-1].shape[2]
        certs = [filters.min_filter(c, opt.reliable_map_min_filter) for c in certs]

        # frame 1 (:276-285): never on the gradient path
        h0, w0 = imgs[0].shape[1], imgs[0].shape[2]
        if first_mode == "zeros":
            out1 = imgs[0].new_zeros((n, h0, w0, 3))
        elif first_mode == "image_model":
            spec_i, params_i = self.image_model
            with torch.no_grad():
                out1 = stylizer.apply(params_i, spec_i, imgs[0], dtype=self._dtype).float()
        else:  # 'self': the video model with a zero prior and certainty
            x0 = torch.cat([imgs[0], imgs[0].new_zeros((n, h0, w0, 4))], dim=-1)
            out1 = self._model(params, x0, grad=False)

        out2 = None
        warped = None
        step_losses = []  # per step (pixel + perceptual), for validation
        for i in range(num_steps):
            if out2 is not None:
                out1 = out2 if opt.full_bptt else out2.detach()
            cert3 = certs[i].expand(n, h, w, 1)
            warped = warp.bilinear_warp(out1, flows[i]) * cert3
            prior = warped
            if opt.fill_occlusions == "uniform-random":
                # the global batch's noise on every rank (the generators stay
                # in step), each rank keeping its own rows of it
                rnd = mesh.local_rows(torch.rand((n * mesh.world(), h, w, 3),
                                                 generator=self.generator, device=self.device))
                prior = warped + vgg_preprocess(rnd) * (1.0 - cert3)
            x = torch.cat([imgs[i + 1], prior, certs[i]], dim=-1)
            grad = torch.is_grad_enabled() and (opt.full_bptt or i == num_steps - 1)
            out2 = self._model(params, x, grad)
            if all_steps:
                # validation scores every unrolled step (train_video.lua:473-494)
                sl = out2.new_zeros(())
                if opt.pixel_loss_weight > 0:
                    sl = sl + opt.pixel_loss_weight * losses.pixel_loss(
                        opt.pixel_loss_type, out2 * certs[i], warped)
                if opt.percep_loss_weight > 0 and self.style_tgts is not None:
                    pstep, _ = losses.perceptual_loss(
                        self.vgg_params, out2, imgs[i + 1], self.style_tgts, self.percep_cfg)
                    sl = sl + opt.percep_loss_weight * pstep
                step_losses.append(sl)

        total = out2.new_zeros(())
        aux: Dict[str, torch.Tensor] = {}
        if opt.percep_loss_weight > 0 and self.style_tgts is not None:
            ploss, per_layer = losses.perceptual_loss(
                self.vgg_params, out2, imgs[num_steps], self.style_tgts, self.percep_cfg)
            total = total + opt.percep_loss_weight * ploss
            aux.update(per_layer)
        if opt.pixel_loss_weight > 0:
            pl = losses.pixel_loss(opt.pixel_loss_type, out2 * certs[num_steps - 1],
                                   warped.detach())
            total = total + opt.pixel_loss_weight * pl
            aux["pixel"] = pl
        if opt.tv_strength > 0:
            total = total + tv.tv_loss(out2, opt.tv_strength) / n
        aux["total"] = total
        if all_steps and step_losses:
            aux["val_sum"] = sum(step_losses)
            aux["val_last"] = step_losses[-1]
        return total, (aux, out2, warped)

    def _backward(self, loss):
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    def _optimizer_step(self, lr: float):
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def _train_step(self, imgs, flows, certs, num_steps: int, first_mode: str, lr: float):
        with device_mod.float32_convs():
            loss, (aux, out2, warped) = self._loss_fn(self.params, imgs, flows, certs,
                                                      num_steps, first_mode)
            self._backward(loss)
            mesh.all_reduce_grads(leaves(self.params))
            self._optimizer_step(lr)
        return (loss.detach(), {k: v.detach() for k, v in aux.items()}, out2.detach(),
                warped.detach())

    def _to_device(self, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
                     for a in arrays)

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def _next_source(self) -> str:
        if self.iteration < self.opt.single_image_until:
            return "single_image"
        return self.wheel[int(self.data_rng.integers(0, len(self.wheel)))]

    def _get_batch(self, split: str, source: str, num_steps: int):
        """(imgs, flows, certs, num_steps) of one batch as device tensors."""
        if source == "video":
            imgs, flows, certs = self.video_source.get_batch(split, num_steps)
        elif source == "vr":
            imgs, flows, certs = data_vr.vr_batch(
                self.image_source.next_images(split), self.data_rng, self.train_hw,
                self._vr_maps)
            num_steps = 1
        else:
            images = self.image_source.next_images(split)
            if source == "single_image":
                imgs, flows, certs = data_mod.single_image_batch(images, 1, self.data_rng)
                num_steps = 1
            else:
                imgs, flows, certs = data_mod.SYNTHETIC_SOURCES[source](
                    images, num_steps, self.data_rng)
        return self._to_device(*imgs), self._to_device(*flows), self._to_device(*certs), num_steps

    def _first_mode(self, source: str) -> str:
        if source == "single_image":
            return "zeros"
        if self.image_model is not None:
            return "image_model"
        return "self"

    def train(self, num_iterations: Optional[int] = None, log_fn=print):
        opt = self.opt
        end = num_iterations or opt.num_iterations
        t_start = time.monotonic()
        while self.iteration < end:
            self.iteration += 1
            t = self.iteration
            lr = schedule_value(self.lr_sched, t)
            if opt.lr_decay_every > 0:
                lr = lr * (opt.lr_decay_factor ** (t // opt.lr_decay_every))
            num_steps = int(schedule_value(self.frame_steps_sched, t))
            source = self._next_source()
            imgs, flows, certs, num_steps = self._get_batch("train", source, num_steps)
            loss, aux, out2, warped = self._train_step(
                imgs, flows, certs, num_steps, self._first_mode(source), lr)
            loss, aux = self._mean_over_ranks(loss, aux)
            loss_val = float(loss)
            self._accumulate(loss_val, aux)
            if t % opt.print_every == 0:
                log_fn(f"Iteration {t} / {end}, loss = {loss_val:.6f} "
                       f"[{source} x{num_steps}] {time.monotonic() - t_start:.1f}s")
            if t % opt.history_every == 0:
                self._flush_history()
            if opt.images_every > 0 and t % opt.images_every == 1 and mesh.rank() == 0:
                self._dump_debug_images(imgs, certs, out2, warped, num_steps)
            if t % opt.checkpoint_every == 0:
                self.validate(log_fn)
                self.save_checkpoint()
        return self

    # ------------------------------------------------------------------

    @staticmethod
    def _mean_over_ranks(loss, aux):
        """The loss and the aux terms as means over the ranks (one
        all-reduce; themselves in a world of one)."""
        if mesh.world() == 1:
            return loss, aux
        keys = list(aux)
        vals = mesh.mean_over_ranks(torch.stack([loss.float()] + [aux[k].float() for k in keys]))
        return vals[0], dict(zip(keys, vals[1:]))

    def _accumulate(self, loss_val: float, aux):
        self._total_accum += loss_val
        for k, v in aux.items():
            if k == "total":
                continue
            self._loss_accum[k] = self._loss_accum.get(k, 0.0) + float(v)

    def _flush_history(self):
        n = self.opt.history_every
        self.train_loss_history.append(self._total_accum / n)
        self._total_accum = 0.0
        for k, v in self._loss_accum.items():
            self.percept_loss_history.setdefault(k, []).append(v / n)
        self._loss_accum = {}

    def _eval_loss(self, imgs, flows, certs, num_steps: int, first_mode: str):
        """Every step's loss of one batch, forward only (the kernels' route)."""
        with torch.no_grad(), device_mod.float32_convs():
            loss, (aux, _, _) = self._loss_fn(self.params, imgs, flows, certs, num_steps,
                                              first_mode, all_steps=True)
        return loss, aux

    def validate(self, log_fn=print) -> float:
        """Validation over every data source (train_video.lua:438-504)."""
        opt = self.opt
        if self.image_source:
            self.image_source.reset("val")
        if self.video_source:
            self.video_source.reset("val")
        num_steps = int(self.frame_steps_sched[-1][1])
        val_loss = 0.0
        val_loss_last = 0.0
        denom = sum(self.mix.values())
        for _ in range(opt.num_val_batches):
            part = 0.0
            part_last = 0.0
            for source, weight in self.mix.items():
                imgs, flows, certs, steps = self._get_batch("val", source, num_steps)
                _, aux = self._eval_loss(imgs, flows, certs, steps, self._first_mode(source))
                _, aux = self._mean_over_ranks(aux["total"], aux)
                part += weight * float(aux["val_sum"]) / steps
                part_last += weight * float(aux["val_last"])
            val_loss += part / denom
            val_loss_last += part_last / denom
        val_loss /= opt.num_val_batches
        val_loss_last /= opt.num_val_batches
        log_fn(f"val loss = {val_loss:.6f}")
        self.val_loss_history.append(val_loss)
        self.val_loss_last_history.append(val_loss_last)
        self.val_loss_history_ts.append(self.iteration)
        return val_loss

    def _dump_debug_images(self, imgs, certs, out2, warped, num_steps):
        """debug/ dumps (train_video.lua:303-309), next to the checkpoint
        rather than in the working directory."""
        base_dir = os.path.dirname(self.opt.checkpoint_name)
        d = os.path.join(base_dir, "debug") if base_dir else "debug"
        os.makedirs(d, exist_ok=True)

        def dep(x):
            return vgg_deprocess(x.detach().float().cpu()).clamp(0, 1).numpy()

        core_io.save_image(f"{d}/in{num_steps + 1}.png", dep(imgs[num_steps][0]))
        core_io.save_image(f"{d}/out{num_steps + 1}.png", dep(out2[0]))
        core_io.save_image(f"{d}/out{num_steps}_warped_masked.png", dep(warped[0]))
        core_io.save_image(f"{d}/mask{num_steps}.png", certs[num_steps - 1][0].cpu().numpy())

    # ------------------------------------------------------------------
    # checkpoints (JSON history + portable model, train_video.lua:507-541)
    # ------------------------------------------------------------------

    def save_checkpoint(self):
        opt = self.opt
        base = opt.checkpoint_name
        d = os.path.dirname(base)
        if d:
            os.makedirs(d, exist_ok=True)
        history = {
            "opt": dataclasses.asdict(opt),
            "train_loss_history": self.train_loss_history,
            "val_loss_history": self.val_loss_history,
            "val_loss_last_history": self.val_loss_last_history,
            "val_loss_history_ts": self.val_loss_history_ts,
            "percept_loss_history": self.percept_loss_history,
            "iter": self.iteration,
        }
        # the history and the model are the same on every rank: rank 0
        # alone writes them (two processes racing on one path corrupt it)
        primary = mesh.rank() == 0
        if primary:
            with open(base + ".json", "w") as f:
                json.dump(history, f)
        num_steps = int(schedule_value(self.frame_steps_sched, self.iteration))
        if primary:
            model_ckpt.save_model(
                f"{base}_{num_steps}.npz",
                model_ckpt.params_to_numpy(self.params),
                {
                    "arch": opt.arch,
                    "in_channels": 7,
                    "padding_type": opt.padding_type,
                    "use_instance_norm": opt.use_instance_norm,
                    "tanh_constant": opt.tanh_constant,
                    "iter": self.iteration,
                },
            )
        # the whole training state, the optimizer's included (the reference
        # drops it, README.md:270)
        self._save_train_state(base + "_state")
        # no rank reads a checkpoint before every rank has written it
        mesh.barrier()

    def _save_train_state(self, path: str):
        if mesh.rank() == 0:   # replicated: the same on every rank
            torch.save({"params": _detached(self.params),
                        "optimizer": self.optimizer.state_dict(),
                        "iteration": self.iteration}, path + ".pt")
        # the RNG streams and data cursors, so a restored run replays the
        # iterations an uninterrupted run would have made; the 128-bit PCG64
        # state goes as decimal strings
        st = self.data_rng.bit_generator.state
        side = {
            "generator_state": self.generator.get_state().tolist(),
            "rng_state": str(st["state"]["state"]),
            "rng_inc": str(st["state"]["inc"]),
            "rng_has_uint32": int(st["has_uint32"]),
            "rng_uinteger": int(st["uinteger"]),
            "image_cursor": self.image_source.cursor if self.image_source else None,
            "video_cursor": self.video_source.cursor if self.video_source else None,
            # the history's running sums since its last flush
            "total_accum": self._total_accum,
            "loss_accum": self._loss_accum,
        }
        with open(path + _rng_sidecar_suffix(), "w") as f:
            json.dump(side, f)

    def restore_train_state(self, path: str):
        """Restore what :meth:`save_checkpoint` wrote under `path`
        ("<base>_state"): parameters, optimizer, iteration, RNG streams,
        cursors, accumulators and, from "<base>.json", the histories."""
        state = torch.load(path + ".pt", map_location=self.device, weights_only=True)
        with torch.no_grad():
            for d, s in zip(leaves(self.params), leaves(state["params"])):
                d.copy_(s)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])
        if self.video_source:
            self.video_source.set_cursor_from_iteration("train", self.iteration + 1)
        # the rank's own sidecar (its data cursors are its shard's), else
        # rank 0's: a checkpoint restores onto a smaller world
        side_path = path + _rng_sidecar_suffix()
        if not os.path.exists(side_path):
            side_path = path + ".rng.json"
        if os.path.exists(side_path):
            with open(side_path) as f:
                side = json.load(f)
            self.generator.set_state(torch.tensor(side["generator_state"], dtype=torch.uint8))
            st = self.data_rng.bit_generator.state
            st["state"]["state"] = int(side["rng_state"])
            st["state"]["inc"] = int(side["rng_inc"])
            st["has_uint32"] = side["rng_has_uint32"]
            st["uinteger"] = side["rng_uinteger"]
            self.data_rng.bit_generator.state = st
            if self.image_source and side["image_cursor"] is not None:
                self.image_source.cursor = side["image_cursor"]
            if self.video_source and side["video_cursor"] is not None:
                self.video_source.cursor = side["video_cursor"]
            self._total_accum = side.get("total_accum", 0.0)
            self._loss_accum = dict(side.get("loss_accum", {}))
        if path.endswith("_state"):
            hist_path = path[: -len("_state")] + ".json"
            if os.path.exists(hist_path):
                with open(hist_path) as f:
                    hist = json.load(f)
                for k in ("train_loss_history", "val_loss_history",
                          "val_loss_last_history", "val_loss_history_ts",
                          "percept_loss_history"):
                    if k in hist:
                        setattr(self, k, hist[k])
        return self


def _rng_sidecar_suffix() -> str:
    """Rank 0 writes ".rng.json" (a one-process checkpoint's name); rank i
    ".rng.p{i}.json", so the ranks' data cursors never collide."""
    r = mesh.rank()
    return ".rng.json" if r == 0 else f".rng.p{r}.json"


def _scale_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """Torch image.scale(img, size): scale so the SHORTER side is `size`
    (the style image, train_video.lua:143-144). Bilinear, antialiased when
    shrinking (``jax.image.resize``'s "bilinear")."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return resize_bilinear(x, (nh, nw)).numpy()
