"""K2 (the residual chain's VALID convs) and K4 (the block convs, SAME and
VALID) in float32: ``csrc/conv3x3_f32.cu`` (``fav_conv3x3_f32``). A
launch in bfloat16 is ``conv_tc``'s."""

import torch

from portbench.harness import work

SYMBOL = "conv3x3_f32"


def _of(count):
    def launch(vr, x, *args, **kwargs):
        return count(x, *args, **kwargs) if x.dtype != torch.bfloat16 else None
    return launch


ENTRIES = (
    ("fast_artistic_videos_tpu_torch.ops.rblock_kernel", "chain_conv",
     _of(work.chain_launch)),
    ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3",
     _of(work.block_launch(1))),
    ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3_valid",
     _of(work.block_launch(0))),
)
