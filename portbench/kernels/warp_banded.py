"""K1, the banded two-pass warp (``csrc/warp_banded.cu``: ``fav_warp_banded``
and ``fav_warp_banded_vec``), in either precision: the image and the flow
read, the image's size written (``harness.work.warp_work``)."""

from portbench.harness import work

SYMBOL = "warp_banded"


def _warp(vr, img, flow, band):
    return work.warp_launch(img, flow, band)


ENTRIES = (("fast_artistic_videos_tpu_torch.ops.warp_kernel", "warp_banded", _warp),)
