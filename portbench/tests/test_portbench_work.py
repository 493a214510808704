"""The yardstick's operation and byte counts against hand counts."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import work  # noqa: E402
from portbench.reference import flow as flow_ref  # noqa: E402
from portbench.reference import flow_pwclite  # noqa: E402
from portbench.reference import stylizer as net_ref  # noqa: E402
from portbench.reference import vr_maps  # noqa: E402

CANONICAL = "c9s1-32,d64,d128,R128,R128,R128,R128,R128,U2,c3s1-64,U2,c9s1-3"
FLOW = os.path.join(ROOT, "fast_artistic_videos_tpu", "assets", "flow_pwclite.npz")


def test_k1_the_1080p_prior_warp_is_bound_by_its_bytes():
    flops, nbytes = work.warp_work((1, 1080, 1920, 3), 4)
    # the RGB frame read and written, the (dx, dy) flow read: 32 bytes a pixel
    assert nbytes == 1080 * 1920 * 32
    assert flops == 8 * 1080 * 1920 * 3
    assert work.least_seconds(nbytes, flops, "float32") == pytest.approx(nbytes / 3.35e12)
    assert work.least_seconds(nbytes, flops, "float32") * 1e3 == pytest.approx(0.0198, abs=1e-4)


def test_k2_a_residual_conv_at_290x500x128():
    flops, nbytes = work.conv_work((1, 290, 500, 128), (128, 128, 3, 3), (288, 498), 4)
    assert flops == 2 * 9 * 128 * 128 * 288 * 498
    assert nbytes == (290 * 500 * 128 + 128 * 128 * 9 + 288 * 498 * 128) * 4 + 128 * 4 + 2 * 128 * 4
    assert work.least_seconds(nbytes, flops, "float32") * 1e3 == pytest.approx(0.631, abs=1e-3)
    # the prologue's affine, the skip's used rows and the emitted input
    f2, b2 = work.conv_work((1, 290, 500, 128), (128, 128, 3, 3), (288, 498), 4,
                            eff=True, skip=True, emit=True)
    assert f2 == flops and b2 == nbytes + 2 * 128 * 4 + 2 * 290 * 500 * 128 * 4


@pytest.mark.parametrize("layer, x, w, out, ms", [
    (0, (1, 1160, 2000, 7), (32, 7, 9, 9), (1160, 2000), 1.257),
    (1, (1, 1160, 2000, 32), (64, 32, 3, 3), (580, 1000), 0.319),
    (2, (1, 580, 1000, 64), (128, 64, 3, 3), (290, 500), 0.319),
])
def test_k3_the_three_front_layers_at_1080p(layer, x, w, out, ms):
    flops, nbytes = work.conv_work(x, w, out, 4, eff=layer > 0)
    assert flops == 2 * w[2] * w[3] * w[1] * w[0] * out[0] * out[1]
    assert work.least_seconds(nbytes, flops, "float32") * 1e3 == pytest.approx(ms, abs=1e-3)


def _hand_canonical(h, w, cin=7):
    """The published net's operations at an (h, w) frame: the front at the
    reflect-padded size, five VALID blocks, the tail."""
    hp, wp = h + 80, w + 80
    f = 2 * 81 * cin * 32 * hp * wp
    f += 2 * 9 * 32 * 64 * (hp // 2) * (wp // 2)
    f += 2 * 9 * 64 * 128 * (hp // 4) * (wp // 4)
    a, b = hp // 4, wp // 4
    for _ in range(5):
        f += 2 * 9 * 128 * 128 * ((a - 2) * (b - 2) + (a - 4) * (b - 4))
        a, b = a - 4, b - 4
    assert (a * 4, b * 4) == (h, w)
    f += 2 * 9 * 128 * 64 * (h // 2) * (w // 2)
    f += 2 * 81 * 64 * 3 * h * w
    return f


def test_the_canonical_net_and_the_flow_by_the_counter_match_hand_counts():
    net = net_ref.parse(CANONICAL)
    assert net.input_pad == 40 and net.total_stride == 4
    like = {}
    for name, shape, _ in net_ref.param_shapes(net):
        node = like
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.empty(shape, device="meta")
    flow_like = flow_ref.load_weights(FLOW, "cpu")
    total = work.model_flops(net, like, flow_pwclite, flow_like, (1080, 1920), 1, 0.5)
    net_only = _hand_canonical(1080, 1920)
    assert 0.62e12 < net_only < 0.70e12
    flow = total - net_only
    # the flow pyramid of one 544x960 frame and two refinements
    assert 0.05e12 < flow < 0.25e12
    # VR: six faces padded to 924 px
    vr = work.model_flops(net, like, flow_pwclite, flow_like, (922, 922), 6, 0.5)
    assert vr - 6 * _hand_canonical(924, 924) > 0


def test_the_strip_areas_of_the_922_px_border_maps():
    areas = [work.mapped_area(m) for m in vr_maps.border_maps(922, 128)]
    assert areas == [922 * 128] * 4
    flops, nbytes = work.strip_prior_work(922, areas, [(0, 0, 0)], False)
    assert nbytes == 922 * 128 * 12 + 922 * 922 * 12
    assert np.isfinite(work.least_seconds(nbytes, flops, "float32"))
