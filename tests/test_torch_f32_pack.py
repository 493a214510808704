"""The float32 3x3 kernel's weight layout and index maps (``csrc/conv3x3_f32.cu``,
kernels K2 and K4 in float32), and those of the float32 front kernel
(``csrc/front_f32.cu``, K3 in float32), on the CPU.

The kernel cannot run here, so its weight indexing is held in Python:
unpacking ``ops/_conv_in.pack_conv3x3_f32_weights``'s layout by the
kernel's index map (chunk of 8 input channels, 16-byte copy of a weight
row into shared memory, a thread's 8 output channels 4cg..4cg+3 and
64+4cg..64+4cg+3) gives back the OIHW weights. The kernel's own
arithmetic is held against the plain versions on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.ops import _conv_in

CC, NB = 8, 128               # the kernel's chunk and channel block


def _chan(cg, j):
    """Block-local output channel of thread channel group cg's j-th
    accumulator (the kernel's weight loads and stores)."""
    return (j & 4) * 16 + 4 * cg + (j & 3)


def _smem_weights(packed, cout, c0, co0):
    """The [c * 9 + tap][128] weight slice that the kernel's 16-byte copies
    put in shared memory for the chunk at input channel c0 and the channel
    block at co0: piece e of the 2304 is row e >> 5, columns 4 (e & 31)..+3,
    read from packed[(c0 * 9 + row) * cout + co0 + 4 (e & 31) ..]."""
    flat = packed.reshape(-1)
    s_w = np.empty((CC * 9, NB), np.float32)
    for e in range(CC * 9 * NB // 4):
        row, q = e >> 5, e & 31
        src = (c0 * 9 + row) * cout + co0 + q * 4
        s_w[row, q * 4:q * 4 + 4] = flat[src:src + 4]
    return s_w


@pytest.mark.parametrize("cin,cout", [(8, 128), (24, 256), (128, 128)])
def test_packed_weights_unpack_to_oihw(cin, cout):
    rng = np.random.default_rng(31)
    w = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
    packed = _conv_in.pack_conv3x3_f32_weights(torch.from_numpy(w))
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.shape == (cin, 3, 3, cout)
    packed = packed.numpy()
    got = np.full_like(w, np.nan)
    for co0, c0 in itertools.product(range(0, cout, NB), range(0, cin, CC)):
        s_w = _smem_weights(packed, cout, c0, co0)
        for c, tap, cg, j in itertools.product(range(CC), range(9), range(16), range(8)):
            co = _chan(cg, j)
            got[co0 + co, c0 + c, tap // 3, tap % 3] = s_w[c * 9 + tap, co]
    np.testing.assert_array_equal(got, w)


def test_thread_channels_cover_the_block_once():
    chans = sorted(_chan(cg, j) for cg in range(16) for j in range(8))
    assert chans == list(range(NB))


def test_packed_f32_weights_are_kept_until_the_weights_change():
    w = torch.randn(128, 16, 3, 3)
    first = _conv_in._f32_weights(w)
    assert _conv_in._f32_weights(w) is first
    w.mul_(2.0)                                  # an in-place update repacks
    again = _conv_in._f32_weights(w)
    assert again is not first
    assert torch.equal(again, _conv_in.pack_conv3x3_f32_weights(w))


def _front_chan(cg, j, n):
    """Block-local output channel of front_f32.cu's thread channel group cg,
    accumulator j, in a block of n channels."""
    return (j >> 2) * (n // 2) + 4 * cg + (j & 3)


@pytest.mark.parametrize("k,cin,cout", [(9, 7, 32), (9, 3, 64), (9, 8, 32),
                                        (3, 32, 64), (3, 64, 128), (3, 16, 192)])
def test_packed_front_weights_unpack_to_oihw(k, cin, cout):
    """front_f32.cu's weights, unpacked by the kernel's index map, give back
    OIHW; the 9x9 layout's padded channels hold zeros. 9x9: per kernel row
    u, piece e of 72 * 32 / 4 is row e // 8 ([tap][channel]), columns
    4 (e % 8).., read from packed[((u * 9) * 8 + row) * cout + co0 + ..];
    the thread reads row v * 8 + c. 3x3 stride 2 (n = 128 where Cout %
    128 == 0, else 64): per chunk k of 8 channels, row e // (n / 4) (c * 9
    + tap) from packed[(8 k * 9 + row) * cout + co0 + ..]; the thread reads
    row c * 9 + 3 u + v."""
    rng = np.random.default_rng(32)
    w = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    packed = _conv_in.pack_front_f32_weights(torch.from_numpy(w))
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.shape == ((9, 9, 8, cout) if k == 9 else (cin, 3, 3, cout))
    flat = packed.numpy().reshape(-1)
    n = 32 if k == 9 else (128 if cout % 128 == 0 else 64)
    rows = 9 * CC                          # a kernel row's (9x9) or a chunk's (3x3) rows
    got = np.full_like(w, np.nan)
    for co0 in range(0, cout, n):
        for part in range(9 if k == 9 else cin // CC):
            s_w = np.empty((rows, n), np.float32)
            for e in range(rows * n // 4):
                row, q = e // (n // 4), e % (n // 4)
                src = (part * rows + row) * cout + co0 + 4 * q
                s_w[row, 4 * q:4 * q + 4] = flat[src:src + 4]
            for c, cg, j in itertools.product(range(CC), range(n // 8), range(8)):
                co = co0 + _front_chan(cg, j, n)
                if k == 9:
                    for v in range(9):
                        val = s_w[v * CC + c, _front_chan(cg, j, n)]
                        if c < cin:
                            got[co, c, part, v] = val
                        else:
                            assert val == 0.0
                else:
                    for u, v in itertools.product(range(3), range(3)):
                        got[co, part * CC + c, u, v] = s_w[c * 9 + 3 * u + v,
                                                           _front_chan(cg, j, n)]
    np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("n", [32, 64, 128])
def test_front_thread_channels_cover_the_block_once(n):
    chans = sorted(_front_chan(cg, j, n) for cg in range(n // 8) for j in range(8))
    assert chans == list(range(n))


def test_packed_front_weights_are_kept_until_the_weights_change():
    w = torch.randn(32, 7, 9, 9)
    first = _conv_in._front_f32_weights(w)
    assert _conv_in._front_f32_weights(w) is first
    w.mul_(2.0)
    again = _conv_in._front_f32_weights(w)
    assert again is not first
    assert torch.equal(again, _conv_in.pack_front_f32_weights(w))
