"""The kernels have no backward, so every kernel entry of the port
(ops.warp_kernel.warp_banded, ops.rblock_kernel.chain_conv,
ops.front_kernel.same_conv, ops.conv_kernel.conv3x3 / conv3x3_valid,
ops.strip_warp_kernel's StripWarp and StripSet) raises when it is handed a
tensor that requires grad under grad mode, on every device
(ops._build.no_grad_inputs): on the CPU here, where the entries run their
plain versions. Under torch.no_grad(), and with tensors that need no
gradient, they run. stylizer.apply(fused=True) with grad-carrying
parameters raises; fused=False trains; the flow estimator's training entry
(apply_multiscale) differentiates through the banded warp's plain
version."""

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.flow import estimator
from fast_artistic_videos_tpu_torch.models import arch_dsl, stylizer
from fast_artistic_videos_tpu_torch.ops import (conv_kernel, front_kernel, rblock_kernel,
                                                strip_warp_kernel, warp_kernel)
from fast_artistic_videos_tpu_torch.video import vr_geometry as vr

G = torch.Generator().manual_seed(0)


def _r(*shape):
    return torch.rand(shape, generator=G)


def _strip():
    m = vr.perspective_warp_map_left(40, 16, 40)
    return strip_warp_kernel.make_static_strip_warp(m)


def _strip_set():
    maps = (vr.perspective_warp_map_left(40, 16, 40), vr.perspective_warp_map_right(40, 16, 40),
            vr.perspective_warp_map_top(40, 16, 40), vr.perspective_warp_map_bottom(40, 16, 40))
    return strip_warp_kernel.StripSet(*(strip_warp_kernel.make_static_strip_warp(m)
                                        for m in maps))


# (name, build(): (call(*tensors), tensors)); the first tensor gets requires_grad
ENTRIES = {
    "warp_banded": lambda: (lambda img, flow: warp_kernel.warp_banded(img, flow, 8),
                            [_r(1, 9, 11, 3), _r(1, 9, 11, 2)]),
    "chain_conv": lambda: (lambda w, x, b: rblock_kernel.chain_conv(x, w, b),
                           [_r(8, 8, 3, 3), _r(9, 10, 8), _r(8)]),
    "same_conv": lambda: (lambda w, x, b: front_kernel.same_conv(x, w, b, 2, 1),
                          [_r(16, 8, 3, 3), _r(12, 10, 8), _r(16)]),
    "conv3x3": lambda: (lambda b, x, w: conv_kernel.conv3x3(x, w, b),
                        [_r(128), _r(2, 6, 7, 128), _r(128, 128, 3, 3)]),
    "conv3x3_valid": lambda: (lambda x, w, b: conv_kernel.conv3x3_valid(x, w, b),
                              [_r(2, 6, 7, 128), _r(128, 128, 3, 3), _r(128)]),
    "strip_warp": lambda: (lambda img: _strip()(img), [_r(40, 40, 3)]),
    "strip_warp_sum": lambda: (lambda *faces: _strip_set().blend(list(faces), _r(40, 40),
                                                                  _r(40, 40) + 1.0),
                               [_r(40, 40, 3) for _ in range(6)]),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_kernel_entry_refuses_a_gradient(name):
    call, tensors = ENTRIES[name]()
    tensors[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call(*tensors)
    with torch.no_grad():
        call(*tensors)
    tensors[0].requires_grad_(False)
    call(*tensors)


SPEC = arch_dsl.parse_arch("c9s1-32,d64,d128,R128,R128,u64,u32,c9s1-3")


def _params(grad):
    p = stylizer.init_params(torch.Generator().manual_seed(1), SPEC, "cpu")

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                v.requires_grad_(grad)
    walk(p)
    return p


@pytest.mark.parametrize("batch", [1, 2])
def test_fused_stylizer_refuses_grad_carrying_params(batch):
    """fused=True routes K3 + K2 at batch 1 and K4 at batch 2 (their plain
    versions on the CPU): with parameters that require grad it raises under
    grad mode and runs under no_grad; fused=False carries the gradient."""
    x = _r(batch, 48, 52, 7) * 100
    params = _params(True)
    with pytest.raises(RuntimeError, match="no backward"):
        stylizer.apply(params, SPEC, x, fused=True)
    with torch.no_grad():
        y_kernels = stylizer.apply(params, SPEC, x, fused=True)
    y = stylizer.apply(params, SPEC, x, fused=False)
    y.sum().backward()
    assert params["layer03"]["conv1"]["w"].grad is not None
    torch.testing.assert_close(y_kernels, y.detach(), rtol=1e-4, atol=1e-3)


def test_inference_params_pass_the_guard():
    """The serving paths' parameters need no gradient: the kernel route
    runs under grad mode too."""
    y = stylizer.apply(_params(False), SPEC, _r(1, 48, 52, 7), fused=True)
    assert not y.requires_grad


def test_flow_estimator_training_entry_differentiates():
    """apply (forward only) refuses grad-carrying weights at its feature
    warps (K1's entry); apply_multiscale, the training entry, takes the
    banded warp's plain version and carries the gradient."""
    params = {k: {n: t.requires_grad_(True) for n, t in v.items()}
              for k, v in estimator.init_params(torch.Generator().manual_seed(2),
                                                device="cpu").items()}
    a, b = _r(1, 32, 32, 3), _r(1, 32, 32, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        estimator.apply(params, a, b)
    outs = estimator.apply_multiscale(params, a, b)
    sum(o.abs().sum() for o in outs).backward()
    assert params["pyr0_a"]["w"].grad is not None
    with torch.no_grad():
        np.testing.assert_allclose(estimator.apply(params, a, b).numpy(),
                                   estimator._upsample2_flow(outs[-1]).detach().numpy(),
                                   rtol=0, atol=1e-5)
