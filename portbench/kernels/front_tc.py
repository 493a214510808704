"""K3 in bfloat16, on the tensor cores: ``csrc/front_tc.cu``
(``fav_front_tc``). A launch in float32 is ``front_f32``'s."""

import torch

from portbench.harness import work

SYMBOL = "front_tc"


def _front(vr, x, *args, **kwargs):
    return work.front_launch(x, *args, **kwargs) if x.dtype == torch.bfloat16 else None


ENTRIES = (("fast_artistic_videos_tpu_torch.ops.front_kernel", "same_conv", _front),)
