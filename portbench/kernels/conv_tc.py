"""K2 and K4 in bfloat16, on the tensor cores: ``csrc/conv_tc.cu``
(``fav_conv_tc``). A launch in float32 is ``conv3x3_f32``'s."""

import torch

from portbench.harness import work

SYMBOL = "conv_tc"


def _of(count):
    def launch(vr, x, *args, **kwargs):
        return count(x, *args, **kwargs) if x.dtype == torch.bfloat16 else None
    return launch


ENTRIES = (
    ("fast_artistic_videos_tpu_torch.ops.rblock_kernel", "chain_conv",
     _of(work.chain_launch)),
    ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3",
     _of(work.block_launch(1))),
    ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3_valid",
     _of(work.block_launch(0))),
)
