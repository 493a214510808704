"""FlowNet 2.0 in the port (``flow/flownet2.py``; K7's plain version,
``ops/correlation_kernel.py``; the family choice, ``flow/family.py``)
against the benchmark's plain float32 reference
(``portbench/reference/flow_flownet2.py``) on the CPU, on weights drawn from
a seed at the published widths (162.5 M parameters): both directions of a
pair, a batch of two pairs, a 3-frame stream through the streaming provider
with its consistency check, the correlation at borders and odd sizes, the
checkpoint, and the family choice of the CLIs and the serving pool.

Tolerances, unless a test says otherwise: the port runs the towers once a
pair and both directions as one batch, the reference each direction alone,
and the correlation's channel sums go in another order, so the two part by
float32 rounding through some 60 layers, near 1e-6 of the flow's largest
value here; 1e-4 of it leaves that room, and the port's bfloat16 convs
(near 1e-2 of it) miss it."""

import os

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.core import io
from fast_artistic_videos_tpu_torch.flow import estimator, family, flownet2
from fast_artistic_videos_tpu_torch.flow.provider import (BatchedStreamingFlowProvider,
                                                          StreamingFlowProvider)
from fast_artistic_videos_tpu_torch.ops import correlation_kernel as ck
from portbench.harness import frames as bench_frames
from portbench.reference import flow as flow_ref
from portbench.reference import flow_flownet2 as ref

SEED = 2 ** 31 + 1919
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this process: the suite runs several workers on
    the host's cores, and torch's thread pools on every core of every
    worker slow the convs here by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return ref.draw(SEED, "cpu")


@pytest.fixture(scope="module")
def checkpoint(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("flownet2") / "flownet2.npz")
    ref.save(path, params)
    return path


def _pan(h, w, n):
    pan = bench_frames.Source(SEED, max(h, w), period=256).pans(1, h, w, (6, 3))[0]
    return torch.from_numpy(np.stack([pan.frame(t) for t in range(n)]))


def _gap(got, want):
    return (got - want).abs().max().item(), want.abs().max().item()


def test_published_widths_and_draw(params):
    n = sum(t.numel() for leaves in params.values() for t in leaves.values())
    assert n == 162_518_818
    assert set(name.split(".")[0] for name in params) == set(flownet2.NETS)
    assert family.family(params) == "flownet2" and flownet2.is_flownet2(params)
    again = ref.draw(SEED, "cpu")
    assert torch.equal(again["flownetc.conv1"]["w"], params["flownetc.conv1"]["w"])
    w = params["flownets_d.conv6_1"]["w"]
    assert w.abs().max().item() <= 1.0 / (1024 * 9) ** 0.5

def test_both_directions_match_the_reference(params):
    """A 64x128 pair (8.3 GFLOP a direction) at flow scale 1: both flows
    against the reference's, and the bfloat16 convs outside the bound."""
    f = _pan(64, 128, 2)
    est = flownet2.FlowNet2Estimator(params, device="cpu")
    fa, fb = est.prep(f[0]), est.prep(f[1])
    assert torch.equal(fa, ref.features(params, f[:1], 1.0))
    ab, ba, maxabs = est.refine_pair(fa, fb, (64, 128))
    with torch.no_grad():
        want_ab, want_ba = ref.pair(params, fa, fb)[0], ref.pair(params, fb, fa)[0]
    for got, want in ((ab, want_ab), (ba, want_ba)):
        gap, scale = _gap(got, want)
        assert got.shape == (64, 128, 2) and scale > 0.01
        assert gap <= REL * scale
    assert maxabs.ndim == 0 and maxabs.item() == ab.abs().max().item()
    half = flownet2.FlowNet2Estimator(params, dtype=torch.bfloat16, device="cpu")
    gap, scale = _gap(half.refine_pair(fa, fb, (64, 128))[0], want_ab)
    assert gap > REL * scale


def test_batched_pairs_match_the_reference(params):
    """Two pairs through the batched entry (the 360-degree driver's), with
    the low-resolution flows of flow scale 0.5."""
    f = _pan(128, 256, 3)
    est = flownet2.FlowNet2Estimator(params, device="cpu")
    fa, fb = est.prep_batch(f[1:], 0.5), est.prep_batch(f[:2], 0.5)
    assert fa.shape == (2, 3, 64, 128)
    full, low_ab, low_ba, maxabs = est.refine_pair_batch(fa, fb, (128, 256), 0.5)
    with torch.no_grad():
        want_ab, want_ba = ref.pair(params, fa, fb), ref.pair(params, fb, fa)
    for got, want in ((low_ab, want_ab), (low_ba, want_ba)):
        gap, scale = _gap(got, want)
        assert gap <= REL * scale
    assert full.shape == (2, 128, 256, 2)
    assert maxabs.item() == low_ab.abs().max().item()


@pytest.mark.parametrize("shape,b_shift", [
    ((1, 256, 8, 16), 0),       # FlowNetC's maps at 64x128
    ((2, 7, 5, 3), 1),          # narrower than the displacements: mostly zero reads
    ((3, 12, 23, 41), 2),       # odd sizes, a shifted batch
    ((1, 3, 41, 45), 0),        # every displacement reaches inside
])
def test_correlation_plain_matches_the_reference_loop(shape, b_shift):
    """K7's plain version against the reference's shift loop (b reading
    zero outside the map), the batch shift as a roll of b: the same sums,
    so float32 rounding alone."""
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    got = ck.correlation(a, b, b_shift=b_shift)
    want = ref.correlation(a, torch.roll(b, -b_shift, 0))
    assert got.shape == (shape[0], 441) + shape[2:]
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert (want[:, 0, :2, :] == 0).all()      # (-20, -20) reads outside the map


def test_correlation_writes_into_a_channel_slice():
    g = torch.Generator().manual_seed(6)
    a = torch.randn(2, 16, 9, 11, generator=g)
    buf = torch.full((2, 32 + 441, 9, 11), 3.0)
    out = ck.correlation(a, a, out=buf[:, 32:], b_shift=1)
    assert out.data_ptr() == buf[:, 32:].data_ptr()
    assert (buf[:, :32] == 3.0).all()
    assert torch.equal(buf[:, 32:], ck.correlation_plain(a, a, b_shift=1))
    with pytest.raises(ValueError):
        ck.correlation(a, a, out=torch.zeros(2, 441, 9, 10))
    with pytest.raises(ValueError):
        ck.correlation(a, a, b_shift=2)


def test_streaming_provider_matches_the_reference_stream(params):
    """Three 128x256 frames of a pan through ``StreamingFlowProvider`` (flow
    at scale 0.5, the certainty eroded at flow resolution) against the
    reference's ``StreamingFlow`` run with the family: the backward flows
    within the bound, the warp band the same, and the certainty the same
    but where a flow difference of that size flips a threshold."""
    f = _pan(128, 256, 3)
    prov = StreamingFlowProvider(flow_estimator=flownet2.FlowNet2Estimator(params, device="cpu"),
                                 flow_scale=0.5, erode_window=7)
    want = flow_ref.StreamingFlow(ref, params, 0.5, 7)
    for t in range(3):
        got, exp = prov(f[t]), want(f[t:t + 1])
        if t == 0:
            assert got is None and exp is None
            continue
        flow, cert = got
        gap, scale = _gap(flow, exp[0][0])
        assert gap <= REL * scale
        assert prov.last_band == exp[2]
        assert (cert - exp[1][0]).abs().mean().item() <= 1e-3


def test_checkpoint_round_trip_and_layouts(params, checkpoint):
    """The reference's npz read by the program: conv kernels OIHW, the
    transposed convs (Cin, Cout, 4, 4), the flow upsamplers of C, S and SD
    without bias and the fusion's with one."""
    read = estimator.load_params(checkpoint, "cpu")
    assert set(read) == set(params)
    for name in ("flownetc.conv1", "flownets_d.deconv5", "flownetfusion.upsampled_flow1_to_0"):
        for leaf, t in params[name].items():
            assert torch.equal(read[name][leaf], t), (name, leaf)
    assert read["flownetc.conv1"]["w"].shape == (64, 3, 7, 7)
    assert read["flownets_d.deconv5"]["w"].shape == (1024, 512, 4, 4)
    assert "b" not in read["flownets_d.upsampled_flow6_to_5"]
    assert read["flownetfusion.upsampled_flow1_to_0"]["b"].shape == (2,)
    with np.load(checkpoint) as z:
        assert z["flownets_d.deconv5/w"].shape == (4, 4, 512, 1024)


def test_every_entry_picks_the_family_by_its_keys(params, checkpoint):
    """The 2D CLI's and the 360-degree CLI's providers, the serving pool and
    make_opt_flow's estimator take FlowNet 2.0 from its checkpoint, and
    PWC-lite from the bundled one, through ``flow.family``."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video, stylize_vr_video
    from fast_artistic_videos_tpu_torch.core.config import StylizeOptions
    from fast_artistic_videos_tpu_torch.models import checkpoint as ckpt
    from fast_artistic_videos_tpu_torch.video.driver_vr import VROptions
    from fast_artistic_videos_tpu_torch.video.serving import StreamPool

    assert isinstance(family.make_estimator(params, device="cpu"), flownet2.FlowNet2Estimator)
    assert isinstance(family.load_estimator("bundled", device="cpu"), estimator.FlowEstimator)
    cpu = torch.device("cpu")
    prov = stylize_video.build_flow_provider(
        StylizeOptions(flow_model=checkpoint, flow_scale=0.5, dtype="float32"), cpu)
    assert isinstance(prov.estimator, flownet2.FlowNet2Estimator)
    del prov
    vr = stylize_vr_video.build_flow_provider(
        VROptions(flow_model=checkpoint, flow_scale=0.5, dtype="bfloat16"), cpu)
    assert isinstance(vr, BatchedStreamingFlowProvider)
    assert isinstance(vr.estimator, flownet2.FlowNet2Estimator)
    assert vr.estimator.params["flownetc.conv1"]["w"].dtype == torch.bfloat16
    del vr
    spec, stylizer_params, _ = ckpt.load_model("demo", "cpu")
    pool = StreamPool(spec, stylizer_params, flow_params=estimator.load_params(checkpoint, cpu),
                      n_streams=2, devices=[cpu], dtype="float32")
    assert all(isinstance(p.estimator, flownet2.FlowNet2Estimator) for p in pool._providers)
    assert pool._providers[0].estimator is pool._providers[1].estimator
    del pool
    bundled = StreamPool(spec, stylizer_params, flow_params=estimator.load_params("bundled", cpu),
                         n_streams=1, devices=[cpu], dtype="float32")
    assert isinstance(bundled._providers[0].estimator, estimator.FlowEstimator)


def test_pyramid_options_raise_for_flownet2(params):
    """fast_check and coarse_backward belong to PWC-lite's pyramid."""
    est = flownet2.FlowNet2Estimator(params, device="cpu")
    f = est.prep(_pan(64, 128, 1)[0])
    with pytest.raises(ValueError, match="FlowNet 2.0"):
        est.refine_pair(f, f, (64, 128), fast_check=True)
    with pytest.raises(ValueError, match="FlowNet 2.0"):
        est.refine_pair(f, f, (64, 128), coarse_backward=True)
    with pytest.raises(ValueError, match="FlowNet 2.0"):
        est.refine_pair_batch(f, f, (64, 128), fast_check=True)
    prov = StreamingFlowProvider(flow_estimator=est, fast_check=True)
    frame = _pan(64, 128, 1)[0]
    assert prov(frame) is None
    with pytest.raises(ValueError, match="FlowNet 2.0"):
        prov(frame)
    with pytest.raises(ValueError, match="not a FlowNet 2.0"):
        flownet2.FlowNet2Estimator(estimator.load_params("bundled", "cpu"), device="cpu")


def test_stylize_cli_runs_with_a_flownet2_checkpoint(checkpoint, tmp_path):
    """The 2D CLI, as a user runs it with ``--flow_model flownet2.npz``:
    three 64x128 frames, the demo net, flow at scale 1, on the CPU."""
    from fast_artistic_videos_tpu_torch.cli import stylize_video

    f = _pan(64, 128, 3).numpy()
    for t in range(3):
        io.save_image(str(tmp_path / f"frame_{t + 1:05d}.ppm"), f[t])
    out = tmp_path / "out"
    os.makedirs(out)
    stylize_video.main(["--input_pattern", str(tmp_path / "frame_%05d.ppm"),
                        "--model_vid", "demo", "--flow_model", checkpoint,
                        "--output_prefix", str(out / "o"), "--device", "cpu"])
    outs = sorted(os.listdir(out))
    assert len(outs) == 3, outs
    assert io.load_image(str(out / outs[-1])).shape == (64, 128, 3)
