"""K5, the 360-degree path's border priors and cross-face blend
(``csrc/strip_warp.cu``: ``fav_strip_warp_sum``; the entries are methods of
``strip_warp_kernel.StripSet``). Counted from the cell's face geometry
(``vr``: the face size and each border map's strip area), in float32."""

from portbench.harness import work
from portbench.reference import video as vref

SYMBOL = "strip_warp"


def _prior(vr, obj, pos, segments, div):
    if vr is None:
        return None
    face, areas = vr
    return (*work.strip_prior_work(face, areas, vref.PRIOR_TERMS[pos], pos in (4, 5)),
            "float32")


def _blend(vr, obj, segments, gm, div):
    if vr is None:
        return None
    face, areas = vr
    return (*work.strip_blend_work(face, areas, vref.BLEND_TERMS), "float32")


ENTRIES = (
    ("fast_artistic_videos_tpu_torch.ops.strip_warp_kernel.StripSet", "prior", _prior),
    ("fast_artistic_videos_tpu_torch.ops.strip_warp_kernel.StripSet", "blend", _blend),
)
