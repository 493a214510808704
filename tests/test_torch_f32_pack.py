"""The float32 3x3 kernel's weight layout and index maps (``csrc/conv3x3_f32.cu``,
kernels K2 and K4 in float32), on the CPU.

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
