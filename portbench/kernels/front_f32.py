"""K3, the stylizer's three front layers, in float32: ``csrc/front_f32.cu``
(``fav_front_f32``). A launch in bfloat16 is ``front_tc``'s."""

import torch

from portbench.harness import work

SYMBOL = "front_f32"


def _front(vr, x, *args, **kwargs):
    return work.front_launch(x, *args, **kwargs) if x.dtype != torch.bfloat16 else None


ENTRIES = (("fast_artistic_videos_tpu_torch.ops.front_kernel", "same_conv", _front),)
