"""CLI: train a video style-transfer model with the PyTorch port — flag
parity with ``th train_video.lua`` (train_video.lua:20-78) and with
``fast_artistic_videos_tpu/cli/train.py``, plus ``--device`` (default
``cuda``; there is no silent fallback to the CPU).

Example:
  python -m fast_artistic_videos_tpu_torch.cli.train \\
      --h5_file coco.h5 --h5_file_video video.h5 \\
      --style_image styles/candy.jpg --loss_network vgg16.npz \\
      --image_model candy-image.npz --checkpoint_name out/candy

Data-parallel (``--num_data_devices N``, ``--batch_size`` global): one
process per card, launched with ``torchrun --nproc_per_node N -m
fast_artistic_videos_tpu_torch.cli.train ...`` (or with RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT set by hand); each process joins the group
(NCCL, gloo with ``--device cpu``) and trains on its card.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..core import device as device_mod
from ..core.config import TrainOptions
from ..models import checkpoint as model_ckpt
from ..models import stylizer
from ..parallel import mesh
from ..train.trainer import Trainer


def add_train_flags(p: argparse.ArgumentParser) -> None:
    defaults = TrainOptions()
    for f in dataclasses.fields(TrainOptions):
        flag = "--" + f.name
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            p.add_argument(flag, type=lambda s: s not in ("0", "false", "False"),
                           default=default)
        else:
            p.add_argument(flag, type=type(default), default=default)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_train_flags(p)
    p.add_argument("--device", default=device_mod.DEFAULT,
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)
    opt = TrainOptions(**{f.name: getattr(args, f.name)
                          for f in dataclasses.fields(TrainOptions)})

    device = args.device
    if opt.num_data_devices > 1 and not mesh.initialized():
        mesh.init_process_group("gloo" if device == "cpu" else None)
    device = mesh.rank_device(device)

    vgg_params = None
    if opt.loss_network and opt.loss_network != "rgb-pyramid":
        from ..video.evaluation import load_vgg_params

        vgg_params = load_vgg_params(opt.loss_network, device)

    image_model = None
    if opt.image_model and opt.image_model != "self":
        spec_i, params_i, _ = model_ckpt.load_model(opt.image_model, device)
        image_model = (spec_i, params_i)

    trainer = Trainer(opt, vgg_params=vgg_params, image_model=image_model, device=device)
    print(f"{stylizer.count_params(trainer.params)} parameters ({opt.arch}) on "
          f"{trainer.device}")
    if opt.resume_from_checkpoint:
        trainer.restore_train_state(opt.resume_from_checkpoint)
    trainer.train()
    trainer.save_checkpoint()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
