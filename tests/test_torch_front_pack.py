"""The weight layout of the front's tensor-core kernel (``csrc/front_tc.cu``,
kernel K3 in bfloat16), on the CPU.

The kernel cannot run here, so its layout logic is held in Python: the conv
computed as one explicit GEMM of an im2col, taken in the order in which the
kernel walks K (per input-channel chunk, k16 step q, half h: the 16-byte
group e = 2q + h of 8 channels, which is kernel row e // 10 and tap e % 10
of a 9x9 layer at 8 channels per pixel, and tap e // G, channel group e % G
of a 3x3 layer at G groups per pixel), against the weights as
``ops/_conv_in.pack_front_weights`` packs them, must equal the plain
version ``conv_in_plain`` in float32 (1e-5, float32 summation order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_artistic_videos_tpu_torch.ops import _conv_in


def _im2col_kernel_order(a, kh, stride, pad, cp):
    """(Ho * Wo, K) of the padded prologue result `a` (H, W, Cin), K in the
    order front_tc.cu walks it, each chunk's K padded to whole 64-wide
    slices (the padding reads zeros, as the kernel's zero weights do)."""
    h, w, cin = a.shape
    gp = cp // 8
    kwp = kh + (kh & 1) if gp == 1 else kh
    nq = kh * kwp * gp // 2
    slices = -(-nq // 4)
    nchunk = -(-cin // cp)
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kh) // stride + 1
    ap = F.pad(a, (0, nchunk * cp - cin, pad, pad + kwp - kh, pad, pad))
    cols = []
    for c in range(nchunk):
        for q in range(4 * slices):
            for half in (0, 1):
                e = 2 * q + half
                if q >= nq:
                    cols.append(torch.zeros(ho, wo, 8))
                    continue
                if gp == 1:
                    u, v, g = e // kwp, e % kwp, 0
                else:
                    tap, g = e // gp, e % gp
                    u, v = tap // kh, tap % kh
                ch = c * cp + 8 * g
                cols.append(ap[u:u + stride * (ho - 1) + 1:stride,
                               v:v + stride * (wo - 1) + 1:stride, ch:ch + 8])
    return torch.cat(cols, dim=-1).reshape(ho * wo, -1), (ho, wo)


@pytest.mark.parametrize("k,stride,pad,cin,cout,chunk", [
    (9, 1, 4, 7, 32, 8), (3, 2, 1, 32, 64, 32), (3, 2, 1, 64, 128, 64),   # layers 0-2
    (9, 1, 4, 3, 64, 8), (3, 2, 1, 96, 128, 32), (3, 2, 1, 128, 64, 64)])
@pytest.mark.parametrize("prologue", [False, True])
def test_packed_weights_gemm_matches_plain(k, stride, pad, cin, cout, chunk, prologue):
    rng = np.random.default_rng(21)
    h, w = 13, 19
    x = torch.from_numpy(rng.standard_normal((h, w, cin)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((cout, cin, k, k))
                           / np.sqrt(k * k * cin)).astype(np.float32))
    wt = wt.to(torch.bfloat16).float()          # the kernel's weights are bf16
    b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    eff = (torch.from_numpy(np.stack([rng.random(cin) + 0.5,
                                      rng.standard_normal(cin)]).astype(np.float32))
           if prologue else None)
    assert _conv_in.front_chunk(k, cin) == chunk
    packed = _conv_in.pack_front_weights(wt)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape[1:] == (cout, 64)
    a = _conv_in._prologue(x, eff, prologue, None)
    cols, (ho, wo) = _im2col_kernel_order(a, k, stride, pad, chunk)
    wmat = packed.float().permute(1, 0, 2).reshape(cout, -1)    # (Cout, K), slices in order
    assert cols.shape[1] == wmat.shape[1]
    y = (cols.double() @ wmat.double().T + b.double()).float().reshape(ho, wo, cout)
    want, _ = _conv_in.conv_in_plain(x, wt, b, stride=stride, pad=pad, eff=eff, relu=prologue)
    scale = want.abs().max().item()
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5 * scale)


def test_packed_weights_padding_is_zero():
    """The 10th tap of each 9x9 kernel row, the 8th channel of a 7-channel
    pixel and the K padding of the last slice hold zero weights."""
    wt = torch.ones(32, 7, 9, 9)
    packed = _conv_in.pack_front_weights(wt).float()
    assert packed.shape == (12, 32, 64)          # 9 rows x 10 taps x 8 ch = 720 -> 768
    k = packed.permute(1, 0, 2).reshape(32, -1)[0]
    assert k[720:].abs().sum() == 0
    per_tap = k[:720].reshape(9, 10, 8)
    assert per_tap[:, 9].abs().sum() == 0 and per_tap[:, :, 7].abs().sum() == 0
    assert per_tap[:, :9, :7].eq(1).all()


def test_packed_weights_are_kept_until_the_weights_change():
    w = torch.randn(64, 32, 3, 3)
    first = _conv_in._front_weights(w)
    assert _conv_in._front_weights(w) is first
    w.mul_(2.0)                                  # an in-place update repacks
    again = _conv_in._front_weights(w)
    assert again is not first
    assert torch.equal(again, _conv_in.pack_front_weights(w))
