"""``models/stylizer.py`` ``layer_plan`` on the CPU: which path takes which
layers of one stylizer call for a shape and a dtype (a pure function: no
net runs), its K3 pattern against the JAX package's phase-io test, and
``apply`` running its plan: the kernel entries it calls, and a resume inside
the residual chain against the plain path. The execution of each path is
held elsewhere (``test_torch_upconv.py``, ``test_torch_front.py``,
``test_torch_rblock.py``, ``test_torch_batch.py``)."""

import pytest
import torch

from fast_artistic_videos_tpu.models import arch_dsl as jarch
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu_torch.models import arch_dsl, stylizer
from fast_artistic_videos_tpu_torch.ops import (conv_kernel, front_kernel, rblock_kernel,
                                                upconv_kernel)

F32, BF16 = torch.float32, torch.bfloat16
HD = (1, 1080, 1920, 7)
K3, K2 = ("K3", (0, 1, 2)), ("K2", (3, 4, 5, 6, 7))
TAIL = [("K6", (8, 9)), ("K6", (10, 11))]
WIDEN = "c9s1-32,d64,d64,C128,R128,U2,c3s1-64,U2,c9s1-3"    # C128's first conv: 64 -> 128


def _torch(*idx):
    return [("torch", (i,)) for i in idx]


def _k4(*idx):
    return [("K4", (i,)) for i in idx]


# case: (arch, shape, dtype, fused, layer_plan keywords, the plan)
PLANS = {
    "K3 at batch 1": ("canonical", HD, F32, True, {}, [K3, K2] + TAIL),
    "no K3 at batch 2, K4 on the R128 blocks": (
        "canonical", (2,) + HD[1:], F32, True, {}, _torch(0, 1, 2) + _k4(3, 4, 5, 6, 7) + TAIL),
    "no K3 when H % 4 != 0": (
        "canonical", (1, 1081, 1920, 7), F32, True, {}, _torch(0, 1, 2) + [K2] + TAIL),
    "chain trimmed by stop_after": ("canonical", HD, F32, True, {"stop_after": 5},
                                    [K3] + _k4(3, 4, 5)),
    "chain trimmed by size": ("canonical", (1, 8, 12, 7), F32, True, {},
                              [K3] + _k4(3, 4, 5, 6, 7) + TAIL),
    "no K4 at width 64": ("c9s1-32,d64,R64,R64,U2,c9s1-3", (2, 64, 64, 7), F32, True, {},
                          _torch(0, 1, 2, 3) + [("K6", (4, 5))]),
    "feature reuse: front tap": ("canonical", HD, F32, True, {"stop_after": 2},
                                 _torch(0, 1, 2)),
    "feature reuse: residual blocks": ("canonical", (1, 270, 480, 128), F32, True,
                                       {"start_at": 3, "stop_after": 7}, [K2]),
    "feature reuse: tail": ("canonical", (1, 250, 460, 128), F32, True, {"start_at": 8}, TAIL),
    "learned upsamples (train-default)": ("train-default", HD, F32, True, {},
                                          [K3, K2] + _torch(8, 9, 10) + [("tanh", ())]),
    "bfloat16: no K6": ("canonical", HD, BF16, True, {},
                        [K3, K2] + _torch(8, 9, 10, 11) + [("tanh", ())]),
    "fused=False": ("canonical", HD, F32, False, {}, _torch(*range(12)) + [("tanh", ())]),
    "widening conv block at batch 2: K4": (
        WIDEN, (2,) + HD[1:], F32, True, {}, _torch(0, 1, 2) + _k4(3, 4) + [("K6", (5, 6)), ("K6", (7, 8))]),
    "resume inside the chain": ("canonical", (1, 262, 472, 128), F32, True, {"start_at": 5},
                                _k4(5, 6, 7) + TAIL),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_layer_plan(case):
    arch, shape, dtype, fused, kw, want = PLANS[case]
    assert stylizer.layer_plan(arch_dsl.parse_arch(arch), shape, dtype, fused, **kw) == want


@pytest.mark.parametrize("arch,kw", [
    ("canonical", {}),
    ("canonical", {"padding_type": "zero"}),
    ("canonical", {"padding_type": "reflect"}),
    ("canonical", {"use_instance_norm": False}),
    ("c9s1-32,d64,R64,R64,U2,c9s1-3", {}),
    ("c9s1-32,d64,d128,U4,R128,c9s1-3", {}),
])
def test_supports_phase_io_matches_jax(arch, kw):
    """The one K3 pattern plus the input pad test gives the JAX package's
    phase-io answer (reflect-padded convs, batch norm and a residual block
    at layer 2 fail the pattern; a block after U4 leaves a 2-px pad)."""
    assert stylizer.supports_phase_io(arch_dsl.parse_arch(arch, **kw)) == \
        jsty.supports_phase_io(jarch.parse_arch(arch, **kw))


def _params(spec, seed):
    """Random parameters whose block convs read the previous layer's width
    (``init_params`` gives a block's first conv the block's own width)."""
    params = stylizer.init_params(torch.Generator().manual_seed(seed), spec, device="cpu")
    for i, layer in enumerate(spec.layers):
        cin = spec.layers[i - 1].out_channels
        if layer.kind in ("conv_block", "res_block") and cin != layer.out_channels:
            w = torch.randn(layer.out_channels, cin, 3, 3, generator=torch.Generator().manual_seed(i))
            params[f"layer{i:02d}"]["conv1"]["w"] = w / (9 * cin) ** 0.5
    return params


@pytest.mark.parametrize("arch,n,dtype,want", [
    ("canonical", 1, F32, {"K3": 3, "K2": 10, "K4": 0, "K6": 2}),
    ("canonical", 1, BF16, {"K3": 3, "K2": 10, "K4": 0, "K6": 0}),
    ("canonical", 2, F32, {"K3": 0, "K2": 0, "K4": 10, "K6": 2}),
    (WIDEN, 2, F32, {"K3": 0, "K2": 0, "K4": 3, "K6": 2}),
], ids=["1-dtype0-want0", "1-dtype1-want1", "2-dtype2-want2", "widening-2-dtype3-want3"])
def test_apply_calls_the_planned_entries(monkeypatch, arch, n, dtype, want):
    """``apply(fused=True)`` calls the kernel entries through their module
    attributes (the benchmark wraps them there) as often as its plan says:
    three K3 convs, two K2 convs a block, one K6 call a fold, and a K4 call
    for each block conv whose input and output widths are multiples of 128
    (a widening block's first conv, 64 -> 128, runs through conv2d)."""
    calls = dict.fromkeys(want, 0)
    for key, mod, name in (("K3", front_kernel, "same_conv"), ("K2", rblock_kernel, "chain_conv"),
                           ("K4", conv_kernel, "conv3x3"), ("K4", conv_kernel, "conv3x3_valid"),
                           ("K6", upconv_kernel, "upconv")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    spec = arch_dsl.parse_arch(arch)
    params = _params(spec, 0)
    x = torch.randn(n, 44, 48, 7, generator=torch.Generator().manual_seed(1)) * 60
    with torch.no_grad():
        y = stylizer.apply(params, spec, x, dtype=dtype, fused=True)
    assert y.shape == (n, 44, 48, 3) and y.dtype == dtype
    assert calls == want


def test_resume_inside_the_chain_matches_plain():
    """A call that resumes at layer 5, inside the residual chain (layers
    3-7), runs layers 5-7 through K4 and then the tail, as the plain path
    does: the chain is planned only when the call runs all of it."""
    spec = arch_dsl.parse_arch("canonical")
    params = stylizer.init_params(torch.Generator().manual_seed(2), spec, device="cpu")
    x = torch.randn(1, 24, 26, 128, generator=torch.Generator().manual_seed(3)) * 3
    with torch.no_grad():
        got = stylizer.apply(params, spec, x, fused=True, start_at=5)
        want = stylizer.apply(params, spec, x, fused=False, start_at=5)
    assert got.shape == want.shape == (1, 48, 56, 3)
    assert (got - want).abs().max().item() / 255.0 <= 1e-5
