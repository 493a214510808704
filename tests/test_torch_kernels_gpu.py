"""The port's CUDA kernels (K1 banded warp, K2 chain conv, K3 front conv,
K4 block conv, K5 strip warp, K6 folded upsample conv, K7 correlation)
against their plain PyTorch versions on a card, the stylizer's kernel paths
(batch 1: K3 + K2; batch > 1: K4; float32 upsample tails: K6) against its
plain (cuDNN) path, FlowNet 2.0 against the benchmark's plain reference,
the trainer's float32 step and optimizer updates as the kernels see them,
and the flow providers' steps replayed from CUDA graphs against eager
steps. Needs a CUDA card: every test skips
without one. This file imports no jax, so on the card host it runs alone:

  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import collections
import contextlib
import threading

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.core import device as device_mod
from fast_artistic_videos_tpu_torch.core.config import TrainOptions
from fast_artistic_videos_tpu_torch.flow import estimator
from fast_artistic_videos_tpu_torch.models import arch_dsl, checkpoint, registry, stylizer, vgg
from fast_artistic_videos_tpu_torch.ops import gram
from fast_artistic_videos_tpu_torch.ops import _conv_in, conv_kernel, front_kernel, rblock_kernel
from fast_artistic_videos_tpu_torch.ops import warp_kernel
from fast_artistic_videos_tpu_torch.ops import correlation_kernel, strip_warp_kernel, upconv_kernel
from fast_artistic_videos_tpu_torch.train import data as tdata
from fast_artistic_videos_tpu_torch.train.trainer import Trainer, leaves
from fast_artistic_videos_tpu_torch.video import driver_vr
from fast_artistic_videos_tpu_torch.video import vr_geometry as vr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


@pytest.mark.parametrize("shape,band,dtype,tol", [
    ((2, 67, 131, 3), 8, torch.float32, 1e-5),
    ((1, 45, 77, 2), 16, torch.float32, 1e-5),
    ((1, 33, 41, 64), 8, torch.float32, 1e-5),
    ((1, 50, 70, 32), 8, torch.bfloat16, 2 ** -7),
] + [
    # every entry and vector width (warp_route): C 2 and 3 one pixel a
    # thread, 5 the scalar path, 16-128 one 16-byte vector a thread; N 1
    # and 6, sizes that are no multiple of a tile (128 or 256 pixels, or
    # 1024 vectors), bands 8 and 32 (the staged flow reaches 64 columns
    # past a tile)
    ((n, h, w, c), band, dtype, 1e-5 if dtype == torch.float32 else 2 ** -7)
    for dtype in (torch.float32, torch.bfloat16)
    for c, n, h, w, band in ((2, 1, 45, 261, 32), (2, 6, 23, 77, 8), (3, 1, 37, 389, 8),
                             (3, 6, 29, 131, 32), (5, 1, 31, 300, 8), (5, 6, 17, 47, 32),
                             (16, 1, 33, 517, 32), (16, 6, 21, 59, 8), (64, 1, 19, 70, 8),
                             (64, 6, 13, 33, 32), (128, 1, 27, 75, 32), (128, 6, 9, 21, 8))
])
def test_warp_kernel_matches_plain(cuda, shape, band, dtype, tol):
    """K1, one launch on the entry warp_route names, against its plain
    version: both compute in float32 from the same taps and weights, so
    they agree to float32 rounding, and to one bf16 rounding step."""
    rng = np.random.default_rng(1)
    img = _t(rng.random(shape), cuda, dtype)
    flow = _t((rng.random(shape[:3] + (2,)) * 2 - 1) * band * 1.3, cuda)
    entry, _ = warp_kernel.warp_route(shape[3], dtype)
    k = warp_kernel.KERNEL
    before = (k.launches, k.routes.get(entry, 0))
    got = warp_kernel.warp_banded(img, flow, band)
    assert (k.launches, k.routes.get(entry, 0)) == (before[0] + 1, before[1] + 1)
    want = warp_kernel.warp_banded_plain(img, flow, band)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_unaligned_image(cuda, dtype):
    """An image that starts off a 16-byte boundary (a view one element into
    a larger tensor) takes the scalar path of fav_warp_banded_vec at 16
    channels and the pixel entry at 3, and agrees with the plain version."""
    rng = np.random.default_rng(14)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for c, want_route in ((16, (warp_kernel.VEC_ENTRY, 1)), (3, (warp_kernel.PIXEL_ENTRY, 3))):
        big = _t(rng.random((2, 7, 9, c)), cuda, dtype)
        img = big.view(-1)[1:1 + 6 * 9 * c].view(1, 6, 9, c)    # one element in
        assert img.is_contiguous() and img.data_ptr() % 16
        assert warp_kernel.warp_route(c, dtype, False) == want_route
        flow = _t((rng.random((1, 6, 9, 2)) * 2 - 1) * 10, cuda)
        k = warp_kernel.KERNEL
        before = k.routes.get(want_route[0], 0)
        got = warp_kernel.warp_banded(img, flow, 8)
        assert k.routes.get(want_route[0], 0) == before + 1
        want = warp_kernel.warp_banded_plain(img, flow, 8)
        assert (got.float() - want.float()).abs().max().item() <= tol


def test_bf16_convs_are_bit_identical_without_the_cached_packs(cuda):
    """K2 and K4 in bfloat16 (conv_tc.cu) read the weights packed once and
    the bias rounded once per tensor: y and the emitted input are
    bit-identical to a launch that packs and rounds afresh (the cache
    attributes cleared). K2's statistics are float32 sums by atomics, whose
    order changes from launch to launch even on the same inputs, so they
    are held to float32 rounding (relative 1e-5)."""
    rng = np.random.default_rng(15)
    x = _t(rng.standard_normal((37, 45, 128)), cuda, torch.bfloat16)
    wt = _t(rng.standard_normal((128, 128, 3, 3)) / 34, cuda)
    b = _t(rng.standard_normal(128) * 0.1, cuda)
    kw = dict(eff=_t(np.stack([rng.random(128) + 0.5, rng.standard_normal(128) * 0.1]), cuda),
              pre_relu=True, emit_input=True)

    def run():
        return (rblock_kernel.chain_conv(x, wt, b, **kw),
                conv_kernel.conv3x3(x[None], wt, b, relu=True),
                conv_kernel.conv3x3_valid(x[None], wt, b))
    run()
    assert hasattr(wt, "_conv_tc_pack") and hasattr(b, "_bias_bfloat16")
    cached = run()
    del wt._conv_tc_pack, b._bias_bfloat16
    fresh = run()
    assert torch.equal(cached[0][0], fresh[0][0]) and torch.equal(cached[0][2], fresh[0][2])
    assert torch.allclose(cached[0][1], fresh[0][1], rtol=1e-5, atol=0)
    assert torch.equal(cached[1], fresh[1]) and torch.equal(cached[2], fresh[2])


def _stats_err(got, want, count):
    """The statistics as the instance norm reads them: the mean's error in
    units of the channel's std, and the variance's relative error."""
    m, mp = got[0] / count, want[0] / count
    v, vp = got[1] / count - m * m, want[1] / count - mp * mp
    return max(((m - mp).abs() / vp.clamp(min=1e-12).sqrt()).max().item(),
               ((v - vp).abs() / vp.clamp(min=1e-12)).max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("eff,relu,skip,emit,narrow_cout", [
    (False, False, False, False, 32), (True, True, False, True, 48),
    (True, False, True, True, 64), (False, False, False, True, 40)])
@pytest.mark.parametrize("c,h,w,wide", [(40, 37, 29, None), (128, 37, 29, 128),
                                        (128, 67, 131, 128), (128, 37, 29, 256)])
def test_chain_conv_kernel_matches_plain(cuda, dtype, tol, eff, relu, skip, emit,
                                         narrow_cout, c, h, w, wide):
    """K2, one launch, against its plain version (relative L2 of y, the
    statistics and `a`: 1e-4 float32, 1e-2 bfloat16), on the entry that
    conv_route names. At 40 input channels (Cout `narrow_cout`) it takes
    the general CUDA-core template (conv_in.cu). At 128 -> 128 or 256 it
    takes the float32 3x3 kernel (conv3x3_f32.cu, 8 x 16 tiles) in float32
    and the tensor-core route (16 x 16 tiles) in bfloat16, at sizes that are
    no multiple of either tile. There the emitted prologue result `a` is
    bit-identical to the plain prologue everywhere, tile borders included
    (both kernels round after the multiply, the add and the skip add as
    PyTorch does), and in bfloat16 the statistics are also held within 1e-2
    as the instance norm reads them."""
    rng = np.random.default_rng(2)
    cout = narrow_cout if c == 40 else wide
    x = _t(rng.standard_normal((h, w, c)), cuda, dtype)
    wt = _t(rng.standard_normal((cout, c, 3, 3)) / np.sqrt(9 * c), cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    kw = dict(eff=_t(np.stack([rng.random(c) + 0.5, rng.standard_normal(c) * 0.1]), cuda)
              if eff else None, pre_relu=relu,
              skip=_t(rng.standard_normal((h + 4, w + 4, c)), cuda, dtype) if skip else None,
              emit_input=emit)
    entry = _conv_in.conv_route(dtype, 3, 3, 1, 0, c, cout)
    assert entry == ("fav_conv_in" if c == 40 else
                     "fav_conv_tc" if dtype == torch.bfloat16 else "fav_conv3x3_f32")
    k = rblock_kernel.KERNEL
    before = (k.launches, k.routes.get(entry, 0))
    got = rblock_kernel.chain_conv(x, wt, b, **kw)
    assert (k.launches, k.routes.get(entry, 0)) == (before[0] + 1, before[1] + 1)
    want = rblock_kernel.chain_conv_plain(x, wt, b, **kw)
    assert got[0].dtype == dtype and got[0].shape == (h - 2, w - 2, cout)
    for g, ref in zip(got, want):
        g, ref = g.float(), ref.float()
        assert ((g - ref).norm() / ref.norm()).item() <= tol
    if entry == "fav_conv_in":
        return
    if entry == "fav_conv_tc":
        assert _stats_err(got[1], want[1], (h - 2) * (w - 2)) <= 1e-2
    if emit:
        assert got[2].dtype == dtype and torch.equal(got[2], want[2])
        # the rows and columns where 8- and 16-pixel tiles meet, explicitly
        for r in (7, 8, 9, 15, 16, 17, h - 1):
            assert torch.equal(got[2][r], want[2][r])
        for q in (15, 16, 17, w - 1):
            assert torch.equal(got[2][:, q], want[2][:, q])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("h,w", [(52, 68), (37, 45), (600, 520)])
@pytest.mark.parametrize("k,stride,pad,cin,cout", [
    (9, 1, 4, 7, 32), (3, 2, 1, 32, 64), (3, 2, 1, 64, 128),   # the stylizer's layers 0-2
    (9, 1, 4, 3, 64), (3, 2, 1, 96, 128), (3, 2, 1, 128, 64),  # other tensor-core widths
    (3, 2, 1, 20, 40)])                                       # CUDA cores in both dtypes
def test_front_conv_kernel_matches_plain(cuda, dtype, tol, prologue, h, w, k, stride, pad,
                                         cin, cout):
    """K3, one launch, against its plain version at sizes that are no
    multiple of its tiles (the largest gives each persistent block of the
    tensor-core route several tiles), with the instance-norm affine + ReLU
    prologue on and off: relative L2 of y and of the statistics 1e-4 in
    float32, 1e-2 in bfloat16. Bfloat16 at the front's shapes takes the
    tensor-core route (front_tc.cu: 9x9 at Cin <= 8; 3x3 stride 2 in 32- or
    64-channel chunks, 64 or 128 output channels per block). There the
    statistics are also held within 1e-2 as the instance norm reads them,
    and y and the statistics within 4e-3 of a float64 conv of the same
    bfloat16 values: one bf16 rounding of y is 1.7e-3 in relative L2, while
    the plain version, cuDNN's bf16 conv, is itself 2.3e-3 and its
    statistics up to 8e-3 from that float64 conv. That is why the affine's
    bias is small here: a channel whose variance is a small difference of
    large sums magnifies the reference's error past 1e-2. Float32 at the
    front's shapes takes the register-tiled kernel (front_f32.cu: 9x9 at
    Cin <= 8 in 32-channel blocks; 3x3 stride 2 in 8-channel chunks, 64 or
    128 output channels per block); there the statistics are also held
    within 1e-4 as the instance norm reads them, and y within 1e-5 of a
    float64 conv of the same float32 values (float32 rounding is ~1e-6).
    The narrow 20 -> 40 conv takes the general template (conv_in.cu) in
    both dtypes."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((h, w, cin)), cuda, dtype)
    wt = _t(rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin), cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    kw = dict(eff=_t(np.stack([rng.random(cin) + 0.5, rng.standard_normal(cin) * 0.1]), cuda)
              if prologue else None, relu=prologue)
    tc = dtype == torch.bfloat16 and cin != 20
    entry = ("fav_conv_in" if cin == 20 else
             "fav_front_tc" if dtype == torch.bfloat16 else "fav_front_f32")
    assert _conv_in.conv_route(dtype, k, k, stride, pad, cin, cout) == entry
    kern = front_kernel.KERNEL
    before = (kern.launches, kern.routes.get(entry, 0))
    got = front_kernel.same_conv(x, wt, b, stride, pad, **kw)
    assert (kern.launches, kern.routes.get(entry, 0)) == (before[0] + 1, before[1] + 1)
    want = front_kernel.same_conv_plain(x, wt, b, stride, pad, **kw)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    assert got[0].dtype == dtype and got[0].shape == (ho, wo, cout)
    for g, ref in zip(got, want):
        g, ref = g.float(), ref.float()
        assert ((g - ref).norm() / ref.norm()).item() <= tol
    if tc:
        assert _stats_err(got[1], want[1], ho * wo) <= 1e-2
        a = _conv_in._prologue(x, kw["eff"], prologue, None).double()   # bf16 values
        ref = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], wt.to(dtype).double(),
                                         b.to(dtype).double(), stride, pad)[0].permute(1, 2, 0)
        y = got[0].double()
        assert ((y - ref).norm() / ref.norm()).item() <= 4e-3
        st = torch.stack([ref.sum(dim=(0, 1)), (ref * ref).sum(dim=(0, 1))])
        assert _stats_err(got[1].double(), st, ho * wo) <= 4e-3
    if entry == "fav_front_f32":
        assert _stats_err(got[1], want[1], ho * wo) <= 1e-4
        a = _conv_in._prologue(x, kw["eff"], prologue, None).double()
        ref = torch.nn.functional.conv2d(a.permute(2, 0, 1)[None], wt.double(), b.double(),
                                         stride, pad)[0].permute(1, 2, 0)
        assert ((got[0].double() - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_front_f32_at_the_stylizers_shapes(cuda, layer):
    """The float32 front kernel at the 1080p stylizer's three layers (after
    the 40 px reflect pad), one launch each on fav_front_f32, against the
    plain version: y and the statistics within 1e-4 (relative L2), the
    statistics also as the instance norm reads them."""
    h, w, cin, cout, k, stride, pad = [(1160, 2000, 7, 32, 9, 1, 4),
                                       (1160, 2000, 32, 64, 3, 2, 1),
                                       (580, 1000, 64, 128, 3, 2, 1)][layer]
    rng = np.random.default_rng(20 + layer)
    x = _t(rng.standard_normal((h, w, cin)), cuda)
    wt = _t(rng.standard_normal((cout, cin, k, k)) / np.sqrt(k * k * cin), cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    kw = dict(eff=_t(np.stack([rng.random(cin) + 0.5, rng.standard_normal(cin) * 0.1]), cuda)
              if layer else None, relu=layer > 0)
    kern = front_kernel.KERNEL
    before = kern.routes.get("fav_front_f32", 0)
    got = front_kernel.same_conv(x, wt, b, stride, pad, **kw)
    assert kern.routes.get("fav_front_f32", 0) == before + 1
    want = front_kernel.same_conv_plain(x, wt, b, stride, pad, **kw)
    assert got[0].shape == want[0].shape
    for g, ref in zip(got, want):
        assert ((g - ref).norm() / ref.norm()).item() <= 1e-4
    assert _stats_err(got[1], want[1], want[0].shape[0] * want[0].shape[1]) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("h,w", [(21, 35), (67, 131)])
def test_block_conv_kernel_matches_plain(cuda, dtype, tol, n, same, cout, relu, h, w):
    """K4, one launch for the whole batch, at sizes that are no multiple of
    the 8 x 16 or 16 x 16 tile, against its plain version (relative L2:
    1e-4 float32, 1e-2 bfloat16). Float32 takes the float32 3x3 kernel
    (conv3x3_f32.cu), bfloat16 the tensor-core route."""
    rng = np.random.default_rng(7)
    c = 128
    x = _t(rng.standard_normal((n, h, w, c)), cuda, dtype)
    wt = _t(rng.standard_normal((cout, c, 3, 3)) / np.sqrt(9 * c), cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    fn = conv_kernel.conv3x3 if same else conv_kernel.conv3x3_valid
    entry = _conv_in.conv_route(dtype, 3, 3, 1, 1 if same else 0, c, cout)
    assert entry == ("fav_conv_tc" if dtype == torch.bfloat16 else "fav_conv3x3_f32")
    k = conv_kernel.KERNEL
    before = (k.launches, k.routes.get(entry, 0))
    got = fn(x, wt, b, relu)
    assert (k.launches, k.routes.get(entry, 0)) == (before[0] + 1, before[1] + 1)
    want = conv_kernel.conv3x3_plain(x, wt, b, relu, 1 if same else 0)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.shape == (n, h if same else h - 2, w if same else w - 2, cout)
    g, ref = got.float(), want.float()
    assert ((g - ref).norm() / ref.norm()).item() <= tol
    if relu:
        assert g.min().item() >= 0.0


@pytest.mark.parametrize("cin", [64, 192, 256])
def test_tensor_core_input_widths(cuda, cin):
    """The tensor-core route at other input widths than the stylizer's 128:
    one 64-channel chunk (an odd number of k steps), and three or four
    chunks, where the two halo buffers are reused. K2 with the full
    prologue (y, statistics, bit-identical `a`) and K4 SAME, against their
    plain versions."""
    rng = np.random.default_rng(13)
    h, w, cout = 23, 41, 128
    x = _t(rng.standard_normal((h, w, cin)), cuda, torch.bfloat16)
    wt = _t(rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin), cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    kw = dict(eff=_t(np.stack([rng.random(cin) + 0.5, rng.standard_normal(cin) * 0.1]), cuda),
              skip=_t(rng.standard_normal((h + 4, w + 4, cin)), cuda, torch.bfloat16),
              emit_input=True)
    before = rblock_kernel.KERNEL.routes.get("fav_conv_tc", 0)
    got = rblock_kernel.chain_conv(x, wt, b, **kw)
    assert rblock_kernel.KERNEL.routes.get("fav_conv_tc", 0) == before + 1
    want = rblock_kernel.chain_conv_plain(x, wt, b, **kw)
    y, yp = got[0].float(), want[0].float()
    assert ((y - yp).norm() / yp.norm()).item() <= 1e-2
    assert _stats_err(got[1], want[1], (h - 2) * (w - 2)) <= 1e-2
    assert torch.equal(got[2], want[2])
    before = conv_kernel.KERNEL.routes.get("fav_conv_tc", 0)
    g4 = conv_kernel.conv3x3(x[None], wt, b, relu=True)
    assert conv_kernel.KERNEL.routes.get("fav_conv_tc", 0) == before + 1
    r4 = conv_kernel.conv3x3_plain(x[None], wt, b, True, 1)
    assert ((g4.float() - r4.float()).norm() / r4.float().norm()).item() <= 1e-2


def test_route_counters_rise_once_per_launch(cuda):
    """Three bfloat16 launches add three to `launches` and to the
    tensor-core route; a float32 launch adds one to `launches` and to the
    float32 3x3 route, none to the tensor-core one."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((2, 12, 20, 128)), cuda, torch.bfloat16)
    wt = _t(rng.standard_normal((128, 128, 3, 3)) / 34, cuda)
    b = _t(rng.standard_normal(128) * 0.1, cuda)
    k = conv_kernel.KERNEL
    k.reset()
    for _ in range(3):
        conv_kernel.conv3x3(x, wt, b)
    assert k.launches == 3 and k.routes == {"fav_conv_tc": 3}
    conv_kernel.conv3x3(x.float(), wt, b)
    assert k.launches == 4 and k.routes == {"fav_conv_tc": 3, "fav_conv3x3_f32": 1}
    k.reset()
    assert k.launches == 0 and k.routes == {}


def test_stylizer_bf16_batch1_takes_the_tensor_cores(cuda):
    """The batch-1 stylizer in bfloat16: K3 three launches on the front's
    tensor-core route, K2 ten on the 3x3 tensor-core route and none
    elsewhere, within mean-abs/255 1e-2 of the cuDNN path."""
    spec, params, _ = checkpoint.load_model("demo", cuda)
    x = _t(np.random.default_rng(12).standard_normal((1, 96, 128, 7)) * 60, cuda,
           torch.bfloat16)
    kernels = (front_kernel.KERNEL, rblock_kernel.KERNEL, conv_kernel.KERNEL)
    for k in kernels:
        k.reset()
    got = stylizer.apply(params, spec, x, dtype=torch.bfloat16)
    assert [dict(k.routes) for k in kernels] == [{"fav_front_tc": 3}, {"fav_conv_tc": 10}, {}]
    want = stylizer.apply(params, spec, x, dtype=torch.bfloat16, fused=False)
    assert (got.float() - want.float()).abs().mean().item() / 255.0 <= 1e-2


def _vr_maps(face, overlap):
    return [vr.perspective_warp_map_left(face, overlap, face),
            vr.perspective_warp_map_right(face, overlap, face),
            vr.perspective_warp_map_top(face, overlap, face),
            vr.perspective_warp_map_bottom(face, overlap, face)]


@pytest.mark.parametrize("face,overlap", [(64, 16), (200, 28)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [None, 3])
def test_strip_warp_kernel_matches_plain(cuda, face, overlap, dtype, batch):
    """K5 on the four VR border maps, one image or a batch sharing the map,
    against its plain version on the same (dtype-rounded) input: the
    kernel and the plain version read the same taps and weights and compute
    in float32, so they agree to float32 rounding (1e-5)."""
    rng = np.random.default_rng(6)
    shape = (face, face, 3) if batch is None else (batch, face, face, 3)
    img = _t(rng.random(shape), cuda, dtype)
    for m in _vr_maps(face, overlap):
        fn = strip_warp_kernel.make_static_strip_warp(m)
        before = strip_warp_kernel.KERNEL.launches
        got = fn(img)
        assert strip_warp_kernel.KERNEL.launches == before + 1
        want = fn.plain(img)
        assert got.dtype == torch.float32 and got.shape == want.shape == shape
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("case", [1, 2, 3, 4, 5, "blend"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("face,overlap,views", [(64, 16, False), (200, 28, True)])
def test_strip_sum_kernel_matches_plain(cuda, case, dtype, face, overlap, views):
    """K5's summing entry, one launch per border prior (positions 1-5, the
    faces not yet done None) and one for the cross-face blend of all six
    faces, against its plain version (the composition of the single-map
    plain warps, rotated copies and torch ops) on the same faces: float32
    1e-5. The faces are float32 or bfloat16, contiguous or (views) row
    slices of a larger tensor, as the engine returns its unpadded output."""
    rng = np.random.default_rng(9)
    opt = driver_vr.VROptions(overlap_pixel_w=overlap, overlap_pixel_h=overlap)
    g = driver_vr._Geometry(face, face, opt, cuda)
    assert isinstance(g.borders, strip_warp_kernel.StripSet)
    big = _t(rng.random((6, face + 3, face + 5, 3)), cuda, dtype)
    faces = [big[p, :face, :face] if views else big[p, :face, :face].contiguous()
             for p in range(6)]
    k = strip_warp_kernel.KERNEL
    before = (k.launches, k.routes.get("fav_strip_warp_sum", 0))
    if case == "blend":
        got = g.borders.blend(faces, g.grad_all, g.mask_all_div)
        want = g.borders.blend_plain(faces, g.grad_all, g.mask_all_div)
    else:
        done = [faces[i] if i < case else None for i in range(4)]
        got = [g.borders.prior(case, done, g.mask_all_div)]
        want = [g.borders.prior_plain(case, done, g.mask_all_div)]
    assert (k.launches, k.routes.get("fav_strip_warp_sum", 0)) == (before[0] + 1,
                                                                   before[1] + 1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (face, face, 3) == b.shape
        assert (a - b).abs().max().item() <= 1e-5


def test_stylizer_kernel_path_matches_plain_path(cuda):
    """Batch 1 in float32: K3 three launches on the float32 front kernel,
    K2 ten on the float32 3x3 kernel, within max-abs/255 1e-3 of the cuDNN
    path."""
    spec, params, _ = checkpoint.load_model("demo", cuda)
    x = _t(np.random.default_rng(4).standard_normal((1, 96, 128, 7)) * 60, cuda)
    kernels = (front_kernel.KERNEL, rblock_kernel.KERNEL, conv_kernel.KERNEL)
    before = [k.launches for k in kernels]
    routes = [dict(k.routes) for k in kernels]
    got = stylizer.apply(params, spec, x)                 # CUDA: kernels by default
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 10, 0]
    assert [k.routes.get(e, 0) - r.get(e, 0) for k, r, e in zip(
        kernels, routes, ("fav_front_f32", "fav_conv3x3_f32", "fav_conv3x3_f32"))] == [3, 10, 0]
    want = stylizer.apply(params, spec, x, fused=False)
    assert (got - want).abs().max().item() / 255.0 <= 1e-3


def test_stylizer_batched_kernel_path_matches_plain_path(cuda):
    """Batch 3: the residual blocks go through K4 (10 launches, one per
    conv for the whole batch, on the float32 3x3 kernel), against the cuDNN
    path."""
    spec, params, _ = checkpoint.load_model("demo", cuda)
    x = _t(np.random.default_rng(8).standard_normal((3, 64, 96, 7)) * 60, cuda)
    kernels = (front_kernel.KERNEL, rblock_kernel.KERNEL, conv_kernel.KERNEL)
    before = [k.launches for k in kernels]
    f32 = conv_kernel.KERNEL.routes.get("fav_conv3x3_f32", 0)
    got = stylizer.apply(params, spec, x)
    assert [k.launches - b for k, b in zip(kernels, before)] == [0, 0, 10]
    assert conv_kernel.KERNEL.routes.get("fav_conv3x3_f32", 0) == f32 + 10
    want = stylizer.apply(params, spec, x, fused=False)
    assert (got - want).abs().max().item() / 255.0 <= 1e-3


@pytest.mark.parametrize("shape,k,cout,prologue,last", [
    ((1, 270, 480, 128), 3, 64, True, False),     # 1080p, layer 9
    ((1, 540, 960, 64), 9, 3, True, True),        # 1080p, layer 11 (tanh)
    ((1, 231, 231, 128), 3, 64, True, False),     # a 922-px face (padded to 924)
    ((1, 462, 462, 64), 9, 3, True, True),
    ((2, 13, 37, 16), 3, 32, False, False),       # ragged tiles, two samples
    ((3, 9, 133, 8), 9, 3, False, False),
])
def test_upconv_kernel_matches_plain(cuda, shape, k, cout, prologue, last):
    """K6, one launch, against its plain version (cuDNN's float32 conv of
    the folded weights): the same sums in another order, so float32
    rounding; the statistics through float32 atomics."""
    rng = np.random.default_rng(6)
    n, _, _, cin = shape
    x = _t(rng.standard_normal(shape), cuda)
    w = _t(rng.standard_normal((cout, cin, k, k)) / (k * k * cin) ** 0.5, cuda)
    b = _t(rng.standard_normal(cout) * 0.1, cuda)
    eff = _t(np.stack([rng.random((n, cin)) + 0.5, rng.standard_normal((n, cin))], 1),
             cuda) if prologue else None
    kw = dict(eff=eff, relu=prologue, stats=not last, tanh_scale=150.0 if last else None)
    k6 = upconv_kernel.KERNEL
    before = (k6.launches, k6.routes.get(upconv_kernel.ENTRY, 0))
    got = upconv_kernel.upconv(x, w, b, **kw)
    assert (k6.launches, k6.routes.get(upconv_kernel.ENTRY, 0)) == (before[0] + 1,
                                                                     before[1] + 1)
    want = upconv_kernel.upconv_plain(x, w, b, **kw)
    if last:
        got, want = (got, None), (want, None)
    y, wy = got[0], want[0]
    assert y.shape == (n, 2 * shape[1], 2 * shape[2], cout)
    assert (y - wy).abs().max().item() <= 2e-5 * wy.abs().max().item()
    if not last:
        assert torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("constant", [0.0, -2.5, 150.0])
def test_upconv_kernel_applies_tanh_whatever_the_constants_sign(cuda, constant):
    """K6's last-layer epilogue against its plain version for a tanh
    constant of 0, below 0 and the usual 150: the tanh applies by its own
    flag, not by the constant's sign."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((1, 11, 19, 64)), cuda)
    w = _t(rng.standard_normal((3, 64, 9, 9)) / (81 * 64) ** 0.5, cuda)
    b = _t(rng.standard_normal(3), cuda)
    got = upconv_kernel.upconv(x, w, b, tanh_scale=constant)
    want = upconv_kernel.upconv_plain(x, w, b, tanh_scale=constant)
    assert (got - want).abs().max().item() <= 2e-5 * max(abs(constant), 1.0)
    if constant == 0.0:
        assert not got.any()

def test_stylizer_tail_takes_k6_and_never_synchronises(cuda):
    """The canonical net in float32: two K6 launches a frame (layers 8-9
    and 10-11), within max-abs/255 1e-3 of the cuDNN path; the tail, resumed
    at layer 8 as the feature-reuse path does, runs under
    ``set_sync_debug_mode("error")`` (folded weights built at the first
    call), so a synchronisation added to the route later fails here."""
    spec = arch_dsl.parse_arch("canonical")
    params = stylizer.init_params(torch.Generator(device="cuda").manual_seed(3), spec,
                                  device=cuda)
    x = _t(np.random.default_rng(7).standard_normal((1, 60, 76, 7)) * 60, cuda)
    k6 = upconv_kernel.KERNEL
    with torch.no_grad():
        before = k6.launches
        got = stylizer.apply(params, spec, x)
        assert k6.launches == before + 2
        want = stylizer.apply(params, spec, x, fused=False)
        assert (got - want).abs().max().item() / 255.0 <= 1e-3
        feats = stylizer.apply(params, spec, x, stop_after=7)
        stylizer.apply(params, spec, feats, start_at=8)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tail = stylizer.apply(params, spec, feats, start_at=8)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (tail - got).abs().max().item() / 255.0 <= 1e-5   # atomics' order


def test_kernels_launch_on_the_tensors_card(cuda):
    """A tensor on cuda:N launches on card N while card 0 is current, and
    from another thread too (the flow provider runs on the prefetch thread,
    and --flow_device puts it on its own card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(5)
    img = _t(rng.random((1, 40, 56, 3)), dev)
    flow = _t((rng.random((1, 40, 56, 2)) * 2 - 1) * 10, dev)
    feat = _t(rng.random((1, 40, 56, 16)), dev)
    # 32 input channels: the conv needs more than the default 48 KiB of
    # shared memory, a limit that is lifted per card
    x = _t(rng.standard_normal((20, 24, 32)), dev)
    wt = _t(rng.standard_normal((32, 32, 3, 3)) / 17, dev)
    b = _t(rng.standard_normal(32) * 0.1, dev)
    # float32 128 -> 128: the float32 3x3 kernel (97 KB of shared memory, a
    # limit lifted per card), K2 with its prologue and K4
    x3 = _t(rng.standard_normal((20, 37, 128)), dev)
    e3 = _t(np.stack([rng.random(128) + 0.5, rng.standard_normal(128) * 0.1]), dev)
    s3 = _t(rng.standard_normal((24, 41, 128)), dev)
    # bfloat16 128 -> 128: the tensor-core kernel, whose larger shared-memory
    # limit is lifted per card as well
    xb = _t(rng.standard_normal((20, 24, 128)), dev, torch.bfloat16)
    wb = _t(rng.standard_normal((128, 128, 3, 3)) / 34, dev)
    bb = _t(rng.standard_normal(128) * 0.1, dev)
    # bfloat16 3x3 stride 2, 32 -> 64: the front's tensor-core kernel
    xf = _t(rng.standard_normal((21, 27, 32)), dev, torch.bfloat16)
    wf = _t(rng.standard_normal((64, 32, 3, 3)) / 17, dev)
    bf = _t(rng.standard_normal(64) * 0.1, dev)
    ef = _t(np.stack([rng.random(32) + 0.5, rng.standard_normal(32)]), dev)

    # float32 front: 9x9 (7 -> 32) and 3x3 stride 2 (32 -> 64, prologue),
    # each with its shared-memory limit lifted per card
    x9 = _t(rng.standard_normal((23, 37, 7)), dev)
    w9 = _t(rng.standard_normal((32, 7, 9, 9)) / 24, dev)
    b9 = _t(rng.standard_normal(32) * 0.1, dev)

    face = _t(rng.random((40, 40, 3)), dev)
    strip = strip_warp_kernel.make_static_strip_warp(_vr_maps(40, 12)[2])
    # K5's summing entry: the cross-face blend of six faces, one launch
    geo = driver_vr._Geometry(40, 40, driver_vr.VROptions(overlap_pixel_w=12,
                                                          overlap_pixel_h=12), dev)
    faces = [_t(rng.random((40, 40, 3)), dev) for _ in range(6)]

    def rel(g, ref):
        g, ref = g.float(), ref.float()
        return ((g - ref).norm() / ref.norm()).item()

    def check():
        got = warp_kernel.warp_banded(img, flow, 8)
        want = warp_kernel.warp_banded_plain(img, flow, 8)
        assert (got - want).abs().max().item() <= 1e-5
        # K1's vector entry: 16 channels, one 16-byte vector a thread
        before = warp_kernel.KERNEL.routes.get(warp_kernel.VEC_ENTRY, 0)
        got = warp_kernel.warp_banded(feat, flow, 8)
        assert warp_kernel.KERNEL.routes.get(warp_kernel.VEC_ENTRY, 0) == before + 1
        assert (got - warp_kernel.warp_banded_plain(feat, flow, 8)).abs().max().item() <= 1e-5
        # K5's tables are uploaded to the card of the first call's tensor
        assert (strip(face) - strip.plain(face)).abs().max().item() <= 1e-5
        for g, ref in zip(rblock_kernel.chain_conv(x, wt, b),
                          rblock_kernel.chain_conv_plain(x, wt, b)):
            assert rel(g, ref) <= 1e-4
        kernels = (rblock_kernel.KERNEL, conv_kernel.KERNEL)
        before = [k.routes.get("fav_conv3x3_f32", 0) for k in kernels]
        kw = dict(eff=e3, skip=s3, emit_input=True)
        for g, ref in zip(rblock_kernel.chain_conv(x3, wb, bb, **kw),
                          rblock_kernel.chain_conv_plain(x3, wb, bb, **kw)):
            assert rel(g, ref) <= 1e-4
        assert rel(conv_kernel.conv3x3(x3[None], wb, bb, relu=True),
                   conv_kernel.conv3x3_plain(x3[None], wb, bb, True)) <= 1e-4
        assert [k.routes.get("fav_conv3x3_f32", 0) for k in kernels] == [n + 1 for n in before]
        before = [k.routes.get("fav_conv_tc", 0) for k in kernels]
        for g, ref in zip(rblock_kernel.chain_conv(xb, wb, bb),
                          rblock_kernel.chain_conv_plain(xb, wb, bb)):
            assert rel(g, ref) <= 1e-2
        assert rel(conv_kernel.conv3x3(xb[None], wb, bb),
                   conv_kernel.conv3x3_plain(xb[None], wb, bb)) <= 1e-2
        assert [k.routes.get("fav_conv_tc", 0) for k in kernels] == [n + 1 for n in before]
        before = front_kernel.KERNEL.routes.get("fav_front_tc", 0)
        for g, ref in zip(front_kernel.same_conv(xf, wf, bf, 2, 1, eff=ef, relu=True),
                          front_kernel.same_conv_plain(xf, wf, bf, 2, 1, eff=ef, relu=True)):
            assert rel(g, ref) <= 1e-2
        assert front_kernel.KERNEL.routes.get("fav_front_tc", 0) == before + 1
        before = front_kernel.KERNEL.routes.get("fav_front_f32", 0)
        for args in ((x9, w9, b9, 1, 4), (x, wf, bf, 2, 1)):
            kw = dict(eff=ef, relu=True) if args[3] == 2 else {}
            for g, ref in zip(front_kernel.same_conv(*args, **kw),
                              front_kernel.same_conv_plain(*args, **kw)):
                assert rel(g, ref) <= 1e-4
        assert front_kernel.KERNEL.routes.get("fav_front_f32", 0) == before + 2
        before = strip_warp_kernel.KERNEL.routes.get("fav_strip_warp_sum", 0)
        for g, ref in zip(geo.borders.blend(faces, geo.grad_all, geo.mask_all_div),
                          geo.borders.blend_plain(faces, geo.grad_all, geo.mask_all_div)):
            assert (g - ref).abs().max().item() <= 1e-5
        assert strip_warp_kernel.KERNEL.routes.get("fav_strip_warp_sum", 0) == before + 1

    assert torch.cuda.current_device() == 0
    check()
    errors = []

    def in_thread():
        try:
            check()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
    t = threading.Thread(target=in_thread)
    t.start()
    t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.zeros(1, 8, 8, 3, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        warp_kernel.warp_banded(x, torch.zeros(1, 8, 8, 2, device=cuda), 8)
    strip = strip_warp_kernel.make_static_strip_warp(_vr_maps(32, 8)[0])
    with pytest.raises(TypeError):
        strip(x)
    geo = driver_vr._Geometry(32, 32, driver_vr.VROptions(overlap_pixel_w=8,
                                                          overlap_pixel_h=8), cuda)
    faces = [torch.zeros(32, 32, 3, device=cuda) for _ in range(6)]
    with pytest.raises(ValueError):                         # a float16 face
        geo.borders.blend(faces[:5] + [faces[5].half()], geo.grad_all, geo.mask_all_div)
    with pytest.raises(ValueError):                         # a face of another size
        geo.borders.prior(1, [torch.zeros(32, 30, 3, device=cuda)] + [None] * 3,
                          geo.mask_all_div)
    with pytest.raises(ValueError):                         # float32 front, emits no input
        _conv_in.conv_in(
            front_kernel.KERNEL, torch.zeros(20, 20, 7, device=cuda),
            torch.zeros(32, 7, 9, 9, device=cuda), torch.zeros(32, device=cuda),
            stride=1, pad=4, emit_input=True)
    with pytest.raises(ValueError):
        rblock_kernel.chain_conv(torch.zeros(8, 8, 4, device=cuda),
                                 torch.zeros(4, 5, 3, 3, device=cuda),
                                 torch.zeros(4, device=cuda))
    w4, b4 = torch.zeros(128, 128, 3, 3, device=cuda), torch.zeros(128, device=cuda)
    x4 = torch.zeros(2, 8, 8, 128, device=cuda)
    with pytest.raises(TypeError):
        conv_kernel.conv3x3(x4.half(), w4, b4)
    with pytest.raises(ValueError):                         # bfloat16 outside K4's widths
        conv_kernel.conv3x3(torch.zeros(2, 8, 8, 96, device=cuda, dtype=torch.bfloat16),
                            torch.zeros(128, 96, 3, 3, device=cuda), b4)
    with pytest.raises(ValueError):                         # float32 outside K4's widths
        conv_kernel.conv3x3(torch.zeros(2, 8, 8, 12, device=cuda),
                            torch.zeros(128, 12, 3, 3, device=cuda), b4)
    with pytest.raises(ValueError):                         # not contiguous NHWC
        conv_kernel.conv3x3(x4.permute(0, 2, 1, 3), w4, b4)
    with pytest.raises(ValueError):                         # a 5x5 kernel
        conv_kernel.conv3x3_valid(x4, torch.zeros(128, 128, 5, 5, device=cuda), b4)
    with pytest.raises(ValueError):                         # weights on the CPU
        conv_kernel.conv3x3(x4, w4.cpu(), b4)


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


def _rel(got, want):
    got, want = got.double().cpu(), want.double()
    return ((got - want).norm() / want.norm()).item()


# float32 against a float64 run of the same function: float32 rounding
# stays near 1e-6 relative; TF32 (10-bit mantissas) is near 1e-3
F32_VS_F64 = 1e-5


@pytest.fixture
def tf32_flag_on(cuda):
    """PyTorch's default for cuDNN convs (allow_tf32 True), restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield cuda
    torch.backends.cudnn.allow_tf32 = saved


def test_float32_stylizer_ignores_the_tf32_flag(tf32_flag_on, monkeypatch):
    """stylizer.apply in float32 on the plain (cuDNN) path, parameters
    placed by the port's entry point, with cuDNN's TF32 flag at PyTorch's
    default: within 1e-5 (relative L2) of a float64 CPU run of the same
    function, and the flag is left as it was. The same run with the scope
    taken away (the port before the repair) misses that tolerance."""
    cuda = tf32_flag_on
    spec = arch_dsl.parse_arch("c9s1-16,d32,d64,R64,R64,u32,u16,c9s1-3", in_channels=7)
    params = stylizer.init_params(torch.Generator().manual_seed(0), spec, device=cuda)
    xn = np.random.default_rng(9).standard_normal((1, 96, 128, 7)) * 60
    got = stylizer.apply(params, spec, _t(xn, cuda), fused=False)
    assert torch.backends.cudnn.allow_tf32 is True
    want = stylizer.apply(_tree(params, lambda t: t.cpu().double()), spec,
                          torch.from_numpy(xn), fused=False)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= F32_VS_F64
    monkeypatch.setattr(device_mod, "float32_convs", contextlib.nullcontext)
    tf32 = stylizer.apply(params, spec, _t(xn, cuda), fused=False)
    assert _rel(tf32, want) > F32_VS_F64


def test_float32_flow_pyramid_ignores_the_tf32_flag(tf32_flag_on, monkeypatch):
    """The flow estimator's convs (the feature pyramid of the bundled
    weights) in float32 with cuDNN's TF32 flag on, against a float64 CPU
    run, as above."""
    cuda = tf32_flag_on
    params = estimator.load_params("bundled", cuda)
    img = np.random.default_rng(10).random((1, 96, 128, 3))
    got = estimator.extract_pyramid(params, _t(img, cuda))
    want = estimator.extract_pyramid(_tree(params, lambda t: t.cpu().double()),
                                     torch.from_numpy(img))
    assert all(_rel(g, w) <= F32_VS_F64 for g, w in zip(got, want))
    monkeypatch.setattr(device_mod, "float32_convs", contextlib.nullcontext)
    tf32 = estimator.extract_pyramid(params, _t(img, cuda))
    assert max(_rel(g, w) for g, w in zip(tf32, want)) > F32_VS_F64


@pytest.fixture
def both_tf32_flags_on(cuda):
    """PyTorch's TF32 switches for cuDNN convs and cuBLAS matmuls both on,
    restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield cuda
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_float32_gram_ignores_the_tf32_flags(both_tf32_flags_on, monkeypatch):
    """The evaluator's Gram product (ops.gram) in float32 on the card with
    both TF32 flags on: within 1e-5 (relative L2) of a float64 CPU product,
    and the flags are left as they were. Without the scope it misses."""
    cuda = both_tf32_flags_on
    x = np.random.default_rng(11).standard_normal((2, 48, 40, 256))
    want = gram.gram_matrix(torch.from_numpy(x))
    got = gram.gram_matrix(_t(x, cuda))
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert got.dtype == torch.float32 and _rel(got, want) <= F32_VS_F64
    monkeypatch.setattr(device_mod, "float32_convs", contextlib.nullcontext)
    assert _rel(gram.gram_matrix(_t(x, cuda)), want) > F32_VS_F64


def test_float32_vgg_ignores_the_tf32_flags(both_tf32_flags_on, monkeypatch):
    """The VGG-16 loss network (models.vgg, full width, every tap up to
    relu4_3) in float32 on the card with both TF32 flags on, against a
    float64 CPU run, as above."""
    cuda = both_tf32_flags_on
    params = vgg.init_params(torch.Generator().manual_seed(3), device=cuda)
    x = np.random.default_rng(12).random((1, 64, 80, 3)) * 255 - 120
    taps = (4, 9, 16, 23)
    got = vgg.extract_features(params, _t(x, cuda), taps)
    want = vgg.extract_features(_tree(params, lambda t: t.cpu().double()),
                                torch.from_numpy(x), taps)
    assert torch.backends.cudnn.allow_tf32 is True
    assert all(_rel(got[t], want[t]) <= F32_VS_F64 for t in taps)
    monkeypatch.setattr(device_mod, "float32_convs", contextlib.nullcontext)
    tf32 = vgg.extract_features(params, _t(x, cuda), taps)
    assert max(_rel(tf32[t], want[t]) for t in taps) > F32_VS_F64


# ---------------------------------------------------------------------------
# training: the float32 step's scope, and the kernels after an optimizer step
# ---------------------------------------------------------------------------

def _train_step_grads(device, dtype=torch.float32, params=None, vgg_params=None):
    """One step of the port's style trainer (canonical architecture, 64x64,
    batch 2, the candy fixture, a shift batch from a numpy seed) at lr 0:
    (params, vgg params, {leaf index: gradient}). On the card the frame-1
    pass runs through K4 (forward only) and the gradient pass through
    cuDNN; in float64 (the CPU reference) every pass is the plain path."""
    opt = TrainOptions(train_img_size="64:64", batch_size=2, data_mix="shift:1",
                       style_image=registry.style_fixture("candy"), style_image_size=64)
    tr = Trainer(opt, vgg_params=vgg_params, device=device)
    if params is not None:
        with torch.no_grad():
            for d, s in zip(leaves(tr.params), leaves(params)):
                d.data = s.to(device, dtype).clone()
        tr.optimizer = tr._make_optimizer()
        tr.style_tgts = [t.to(dtype) for t in tr.style_tgts]
        tr._dtype = dtype
    rng = np.random.default_rng(13)
    imgs, flows, certs = tdata.shift_batch(rng.random((2, 64, 64, 3)), 1, rng)

    def put(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
                     for a in arrays)
    tr._train_step(put(imgs), put(flows), put(certs), 1, "self", 0.0)
    return tr.params, tr.vgg_params, [t.grad for t in leaves(tr.params)]


def test_float32_train_step_ignores_the_tf32_flags(both_tf32_flags_on, monkeypatch):
    """One float32 training step on the card (forward-only frame 1 through
    K4, the gradient pass, the backward of the stylizer, VGG-16 and the Gram
    products, all inside core.device.float32_convs) with both TF32 flags on
    outside the scope, cuDNN deterministic: every leaf's gradient equal
    (1e-6 relative L2) to the same step with both flags off, and within
    1e-2 of the step with float64 parameters, inputs and stylizer on the
    CPU (the trainer rounds the stylizer's output to float32 before the
    loss network, as the JAX trainer does; the one-pass instance-norm
    variance, E[x^2] - E[x]^2, amplifies float32 rounding in the backward:
    2e-3 on the CPU); the conv biases that instance norm cancels (exact
    gradient 0) stay below 1e-6 of the largest norm. The flags are left as
    they were. Without the scope the step misses the flags-off step by
    more than 1e-4."""
    cuda = both_tf32_flags_on
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    params, vgg_params, got = _train_step_grads(cuda)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    vgg64 = _tree(vgg_params, lambda t: t.cpu().double())
    _, _, want64 = _train_step_grads("cpu", torch.float64, params, vgg64)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _, _, off = _train_step_grads(cuda, params=params, vgg_params=vgg_params)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    top = max(w.norm() for w in want64)

    def worst(grads, want):
        out = 0.0
        for g, w, r in zip(grads, want, want64):
            if r.norm() < 1e-6 * top:
                assert g.norm() < 1e-6 * max(x.norm() for x in grads)
                continue
            out = max(out, _rel(g, w.double().cpu()))
        return out
    monkeypatch.setattr(device_mod, "float32_convs", contextlib.nullcontext)
    _, _, tf32 = _train_step_grads(cuda, params=params, vgg_params=vgg_params)
    figures = (worst(got, off), worst(got, want64), worst(tf32, off))
    assert figures[0] <= 1e-6 and figures[1] <= 1e-2 and figures[2] > 1e-4, figures


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
def test_kernel_route_sees_the_weights_after_an_optimizer_step(cuda, dtype, tol):
    """The kernels' packed weights are cached on the tensor by its version
    (ops/_conv_in._packed): torch.optim's in-place update must bump every
    leaf's version, so the next forward-only pass (K4 at batch 2) computes
    with the new weights: it moves, and matches the cuDNN path on them
    (max-abs / 255)."""
    spec = arch_dsl.parse_arch("c9s1-32,d64,d128,R128,R128,u64,u32,c9s1-3")
    params = stylizer.init_params(torch.Generator(device=cuda).manual_seed(5), spec, cuda)
    tensors = leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    x = _t(np.random.default_rng(14).standard_normal((2, 64, 72, 7)) * 60, cuda)
    k4 = conv_kernel.KERNEL
    with torch.no_grad():
        before = k4.launches
        y0 = stylizer.apply(params, spec, x, dtype=dtype)
        assert k4.launches == before + 4
    versions = [t._version for t in tensors]
    stylizer.apply(params, spec, x, dtype=dtype, fused=False).float().square().mean().backward()
    torch.optim.Adam(tensors, lr=1e-2).step()
    assert all(t._version > v for t, v in zip(tensors, versions))
    with torch.no_grad():
        y1 = stylizer.apply(params, spec, x, dtype=dtype)
        want = stylizer.apply(params, spec, x, dtype=dtype, fused=False)
    assert (y1.float() - y0.float()).abs().max().item() / 255.0 > 10 * tol
    assert (y1.float() - want.float()).abs().max().item() / 255.0 <= tol


@pytest.mark.parametrize("shape,b_shift,sliced", [
    ((2, 256, 72, 120), 1, True),     # FlowNetC at 1080p, flow at half scale: both directions
    ((1, 256, 72, 120), 0, False),
    ((1, 20, 13, 37), 0, False),      # maps narrower than the displacements
    ((3, 64, 9, 133), 2, True),       # two column tiles, odd sizes
    ((1, 256, 5, 3), 0, True),
])
def test_correlation_kernel_matches_plain(cuda, shape, b_shift, sliced):
    """K7, one launch, against its plain version: the same products summed
    over the channels in another order, so float32 rounding of a sum of C
    terms (values near 1/sqrt(C) here); written into a channel slice of
    FlowNetC's conv3_1 input, whose other channels it leaves alone."""
    rng = np.random.default_rng(11)
    n, c, h, w = shape
    a, b = _t(rng.standard_normal(shape), cuda), _t(rng.standard_normal(shape), cuda)
    buf = torch.full((n, 32 + correlation_kernel.CHANNELS, h, w), 7.0, device=cuda)
    out = buf[:, 32:] if sliced else None
    k7 = correlation_kernel.KERNEL
    before = (k7.launches, k7.routes.get(correlation_kernel.ENTRY, 0))
    got = correlation_kernel.correlation(a, b, out=out, b_shift=b_shift)
    assert (k7.launches, k7.routes.get(correlation_kernel.ENTRY, 0)) == (before[0] + 1,
                                                                         before[1] + 1)
    want = correlation_kernel.correlation_plain(a, b, b_shift=b_shift)
    assert got.shape == (n, correlation_kernel.CHANNELS, h, w)
    assert (got - want).abs().max().item() <= 2e-6
    if sliced:
        assert got.data_ptr() == buf[:, 32:].data_ptr()
        assert bool((buf[:, :32] == 7.0).all())


def test_correlation_kernel_raises_instead_of_falling_back(cuda):
    a = torch.zeros(1, 8, 6, 6, device=cuda)
    with pytest.raises(TypeError):
        correlation_kernel.correlation(a.half(), a.half())
    with pytest.raises(ValueError):                         # maps of two shapes
        correlation_kernel.correlation(a, torch.zeros(1, 8, 6, 5, device=cuda))
    with pytest.raises(ValueError):                         # an output of another dtype
        correlation_kernel.correlation(
            a, a, out=torch.zeros(1, correlation_kernel.CHANNELS, 6, 6, device=cuda).half())
    with pytest.raises(ValueError):                         # maps on two cards
        correlation_kernel.correlation(a, a.cpu())


def test_flownet2_matches_the_reference_at_the_cell_shape(cuda):
    """FlowNet 2.0 at the published widths on a 1080p pair at flow scale
    0.5 (576x960 padded), both directions, against the benchmark's plain
    reference (every layer per direction, the correlation as a shift loop)
    on the card, both in float32 with TF32 off: cuDNN's algorithms and the
    order of K7's sums part them by float32 rounding through 60 layers; the
    bfloat16 convs miss the same bound."""
    from fast_artistic_videos_tpu_torch.flow import flownet2
    from portbench.reference import flow_flownet2 as ref

    params = ref.draw(2 ** 31 + 19, cuda)
    rng = np.random.default_rng(19)
    base = rng.integers(0, 256, (1092, 1932, 3), dtype=np.uint8)
    frames = torch.from_numpy(np.stack([base[6:1086, 6:1926], base[:1080, 12:1932]])).to(cuda)
    est = flownet2.FlowNet2Estimator(params, device=cuda)
    fa, fb = est.prep(frames[0], 0.5), est.prep(frames[1], 0.5)
    assert fa.shape == (1, 3, 576, 960)
    k7 = correlation_kernel.KERNEL.launches
    full, low_ab, low_ba, _ = est.refine_pair(fa, fb, (1080, 1920), 0.5, with_lowres=True)
    assert correlation_kernel.KERNEL.launches == k7 + 1
    with torch.no_grad():
        want_ab = ref.pair(params, fa, fb)[0, :540]
        want_ba = ref.pair(params, fb, fa)[0, :540]
    scale = want_ab.abs().max().item()
    tol = 1e-4 * scale
    assert (low_ab - want_ab).abs().max().item() <= tol
    assert (low_ba - want_ba).abs().max().item() <= tol
    assert full.shape == (1080, 1920, 2)
    half = flownet2.FlowNet2Estimator(params, dtype=torch.bfloat16, device=cuda)
    _, bf_ab, _, _ = half.refine_pair(fa, fb, (1080, 1920), 0.5, with_lowres=True)
    assert (bf_ab - want_ab).abs().max().item() > tol


# ---------------------------------------------------------------------------
# the flow providers' steps replayed from CUDA graphs (flow/graphs.py)
# ---------------------------------------------------------------------------

# a pan whose step moves the band bucket (at flow scale 0.5 the 40-px steps
# are 20 px of flow: past the smallest bucket of 8) and back
PAN_STEPS = (3, 3, 3, 40, 40, 40, 3, 3, 3, 3)


def _pan(seed, n, h, w, dev):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 16, w + sum(PAN_STEPS), 3), dtype=np.uint8)
    xs = np.cumsum((0,) + PAN_STEPS)
    return [torch.from_numpy(np.ascontiguousarray(base[8:8 + h, xs[t]:xs[t] + w])).to(dev)
            for t in range(n)]


def _tensors(out):
    if out is None:
        return []
    return [t for pair in out for t in pair] if isinstance(out, list) else list(out)


def _feed(providers, clips, n, restart):
    """Frames 0..n-1 of each clip through its provider, interleaved, then
    provider 0 restarted on `restart` frames of its clip: (every output,
    held; a copy of each taken when it was returned; the bands)."""
    outs, copies, bands = [], [], []
    feed = [(p, c[t]) for t in range(n) for p, c in zip(providers, clips)]
    for i, (p, frame) in enumerate(feed + [(None, c) for c in clips[0][:restart]]):
        if p is None:
            p = providers[0]
            if i == len(feed):
                p.reset()
        out = p(frame)
        outs.append(out)
        copies.append([t.clone() for t in _tensors(out)])
        bands.append(p.last_band)
    torch.cuda.synchronize()
    return outs, copies, bands


def _counts(kernels):
    return {k.name: (k.launches, dict(k.routes)) for k in kernels}


# each kernel's Python entry, by module, as the benchmark's launch record
# wraps it
_ENTRIES = {"warp_banded": ("fast_artistic_videos_tpu_torch.ops.warp_kernel", "warp_banded"),
            "correlation_f32": ("fast_artistic_videos_tpu_torch.ops.correlation_kernel",
                                "correlation")}


def _graphed_against_eager(make, clips, n, kernels, monkeypatch, restart=2, threaded=False):
    """Runs `make()`'s providers (one a clip, one estimator) eagerly and
    from graphs; every output of the graphed run bit-identical to the
    eager run's and unchanged by the calls after it, each kernel's
    launches and routes the same, every launch of the graphed run a call
    of the kernel's entry through its module (a wrapper set there counts
    it) with the kernel's span, and the graph spans counted. Returns the
    engine bands, the band buckets the steps read (``_band``, in call
    order) and the names of the graphed run's spans."""
    import importlib

    from fast_artistic_videos_tpu_torch.flow import provider as provider_mod
    from fast_artistic_videos_tpu_torch.utils import profiling

    for k in kernels:
        k.reset()
    with monkeypatch.context() as m:
        m.setattr(provider_mod._Streaming, "_graphs", lambda self, frames: None)
        eager, _, eager_bands = _feed(make(), clips, n, restart)
    eager_counts = _counts(kernels)
    for k in kernels:
        k.reset()
    profiling.clear()
    got = {}
    buckets = []
    band = provider_mod._Streaming._band

    seen = collections.Counter()

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def graphed():
        with profiling.recording(), monkeypatch.context() as m:
            m.setattr(provider_mod._Streaming, "_band",
                      lambda self, flows: buckets.append(band(self, flows)) or buckets[-1])
            for k in kernels:
                mod = importlib.import_module(_ENTRIES[k.name][0])
                m.setattr(mod, _ENTRIES[k.name][1], wrap(k.name, getattr(mod, _ENTRIES[k.name][1])))
            got["run"] = _feed(make(), clips, n, restart)

    if threaded:
        # the 2D driver's flow runs on its prefetch thread while the loop
        # thread launches, waits for its stream and copies frames to the
        # host: a capture must see none of it (a device-wide synchronise
        # during a capture is an error of CUDA's, whatever the thread)
        worker = threading.Thread(target=graphed)
        x = torch.rand(512, 512, device=clips[0][0].device)
        worker.start()
        while worker.is_alive():
            x = (x @ x).clamp_(-1, 1)
            x.sum().cpu()
            torch.cuda.current_stream().synchronize()
        worker.join()
    else:
        graphed()
    outs, copies, bands = got["run"]
    spans = profiling.spans()
    profiling.clear()
    assert bands == eager_bands
    for i, (a, b, c) in enumerate(zip(eager, outs, copies)):
        ta, tb = _tensors(a), _tensors(b)
        assert len(ta) == len(tb) == len(c)
        for x, y, z in zip(ta, tb, c):
            assert torch.equal(x, y), (i, (x - y).abs().max().item())
            assert torch.equal(y, z), i
    assert _counts(kernels) == eager_counts
    names = [s.name for s in spans]
    for k in kernels:
        assert seen[k.name] == names.count(k.span) == k.launches > 0, k.name
    assert names.count("flow") == len(outs)
    return bands, buckets, names


def test_graphed_pwclite_provider_matches_eager_bit_for_bit(cuda, monkeypatch):
    """Two StreamingFlowProviders on one PWC-lite estimator at flow scale
    0.5, interleaved over 540x960 pans whose step moves the band bucket,
    on a thread of their own while another thread launches and
    synchronises; one of them restarted (its first frame and first pair
    then replay too)."""
    from fast_artistic_videos_tpu_torch.flow import provider as provider_mod

    est = estimator.FlowEstimator(estimator.load_params("bundled", cuda), device=cuda)
    clips = [_pan(31 + s, 8, 540, 960, cuda) for s in range(2)]

    def make():
        return [provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5,
                                                   erode_window=7) for _ in clips]

    bands, buckets, names = _graphed_against_eager(make, clips, 8, [warp_kernel.KERNEL],
                                                   monkeypatch, threaded=True)
    assert len({b for b in bands if b is not None}) >= 2, bands
    # the pair, "prep" at the restart, and one check a bucket the graphed
    # steps met (the two first pairs ran eagerly, before the pair's capture)
    assert len(buckets) == 15
    assert names.count("flow.capture") == 2 + len(set(buckets[2:]))
    # 12 graphed pairs and the restart's first pair: two parts each, and
    # the restart's first frame one, each a capture or a replay
    assert names.count("flow.capture") + names.count("flow.replay") == 2 * 13 + 1


def test_graphed_batched_provider_matches_eager_bit_for_bit(cuda, monkeypatch):
    """The BatchedStreamingFlowProvider on six 256-px faces at flow scale
    0.5 (float32 faces, as the VR driver uploads them), the band moving."""
    from fast_artistic_videos_tpu_torch.flow import provider as provider_mod

    est = estimator.FlowEstimator(estimator.load_params("bundled", cuda), device=cuda)
    faces = [_pan(41 + p, 8, 256, 256, cuda) for p in range(6)]
    clip = [torch.stack([f[t] for f in faces]).float() / 255.0 for t in range(8)]

    def make():
        return [provider_mod.BatchedStreamingFlowProvider(flow_estimator=est, flow_scale=0.5)]

    bands, buckets, names = _graphed_against_eager(make, [clip], 8, [warp_kernel.KERNEL],
                                                   monkeypatch)
    assert len({b for b in bands if b is not None}) >= 2, bands
    # steps 2-7 and the restart's first pair are graphed; "prep" at the restart
    assert len(buckets) == 8
    assert names.count("flow.capture") == 2 + len(set(buckets[1:]))


def test_flownet2_provider_stays_eager_on_a_card(cuda):
    """Two StreamingFlowProviders on one FlowNet 2.0 estimator (seeded
    weights at the published widths), 540x960 pans at flow scale 0.5: no
    step is captured or replayed and no graphs are made; each pair runs
    FlowNetC's span and one K7 launch, as the parent's eager step did."""
    from fast_artistic_videos_tpu_torch.flow import flownet2
    from fast_artistic_videos_tpu_torch.flow import graphs as step_graphs
    from fast_artistic_videos_tpu_torch.flow import provider as provider_mod
    from fast_artistic_videos_tpu_torch.utils import profiling
    from portbench.reference import flow_flownet2 as ref

    est = flownet2.FlowNet2Estimator(ref.draw(2 ** 31 + 23, cuda), device=cuda)
    clips = [_pan(51 + s, 4, 540, 960, cuda) for s in range(2)]
    providers = [provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5)
                 for _ in clips]
    correlation_kernel.KERNEL.reset()
    profiling.clear()
    with profiling.recording():
        outs = [p(c[t]) for t in range(4) for p, c in zip(providers, clips)]
        torch.cuda.synchronize()
    names = [s.name for s in profiling.spans()]
    profiling.clear()
    assert sum(o is not None for o in outs) == 6
    assert names.count("flow.capture") == names.count("flow.replay") == 0
    assert names.count("flow.fn2.c") == names.count("kernel.K7") == 6
    assert correlation_kernel.KERNEL.launches == 6
    assert est not in step_graphs._SHARED


def test_graph_captured_under_the_profiler_matches_eager(cuda, monkeypatch):
    """A capture inside a torch.profiler run (a band first met inside a
    traced window) replays as eager runs, and the profiler keeps the
    replayed kernels."""
    from fast_artistic_videos_tpu_torch.flow import provider as provider_mod

    est = estimator.FlowEstimator(estimator.load_params("bundled", cuda), device=cuda)
    clip = _pan(61, 5, 270, 480, cuda)
    with monkeypatch.context() as m:
        m.setattr(provider_mod._Streaming, "_graphs", lambda self, frames: None)
        p = provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5)
        want = [p(f) for f in clip]
    p = provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = [p(f) for f in clip]
        torch.cuda.synchronize()
    for a, b in zip(want, got):
        for x, y in zip(_tensors(a), _tensors(b)):
            assert torch.equal(x, y)
    names = {e.name for e in prof.events()}
    assert "cudaGraphLaunch" in names
    assert any("warp_banded" in n for n in names)
