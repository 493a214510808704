"""The port's Torch7 reader, writer and converters
(fast_artistic_videos_tpu_torch.models.t7, cli.import_t7) against the JAX
package's, on the same bytes: the hand-built streams of
tests/test_t7_fixtures.py (its ByteWriter, written straight from the format)
and the reference-shaped checkpoints of tests/test_t7.py. Parsed objects
are equal; imported parameters equal the JAX ones (OIHW here, HWIO there);
the imported stylizer's output matches the JAX stylizer's within 1e-4 of
its largest value (the tolerance of tests/test_torch_stylizer.py)."""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu.cli import import_t7 as jimport
from fast_artistic_videos_tpu.models import checkpoint as jckpt
from fast_artistic_videos_tpu.models import stylizer as jsty
from fast_artistic_videos_tpu.models import t7 as jt7
from fast_artistic_videos_tpu_torch.cli import import_t7 as timport
from fast_artistic_videos_tpu_torch.models import checkpoint as tckpt
from fast_artistic_videos_tpu_torch.models import stylizer as tsty
from fast_artistic_videos_tpu_torch.models import t7 as tt7

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}_for_port", os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixtures():
    return _test_module("test_t7_fixtures")


@pytest.fixture(scope="module")
def t7_tests():
    return _test_module("test_t7")


def _same(a, b, path="root"):
    """Structural equality of two parsed t7 objects (port vs JAX)."""
    if isinstance(b, jt7.TorchObject):
        assert isinstance(a, tt7.TorchObject), path
        assert a.torch_typename == b.torch_typename, path
        _same(a.attrs, b.attrs, path + "." + b.torch_typename)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and sorted(map(repr, a)) == sorted(map(repr, b)), path
        for k in b:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), path


def _streams(fx):
    """Byte streams built with test_t7_fixtures' ByteWriter."""
    out = []
    rng = np.random.default_rng(0)
    for legacy in (False, True):
        w = fx.ByteWriter()
        w.begin_table(6)
        w.number(1), w.number(3.5)
        w.string("s"), w.string("hello")
        w.string("b"), w.boolean(True)
        w.string("n"), w.nil()
        w.string("t"), w.tensor(rng.random((3, 4)), "torch.DoubleTensor",
                                "torch.DoubleStorage", legacy=legacy)
        w.string("c"), w.tensor(rng.random((2, 5)).astype(np.float32), "torch.CudaTensor",
                                "torch.CudaStorage", legacy=legacy)
        out.append(w)
    # a strided view into a larger storage, with an offset
    w = fx.ByteWriter()
    base = np.arange(24, dtype=np.float32)
    w.tensor(base[2:14].reshape(3, 4)[:, ::2], "torch.FloatTensor", "torch.FloatStorage",
             stride=[4, 2], offset=3, storage=base)
    out.append(w)
    # int / byte tensors, a back-referenced table, skipped functions
    w = fx.ByteWriter()
    w.begin_table(4)
    w.number(1), w.tensor(np.arange(6, dtype=np.int64).reshape(2, 3), "torch.LongTensor",
                          "torch.LongStorage")
    w.number(2), w.tensor(np.arange(5, dtype=np.uint8), "torch.ByteTensor",
                          "torch.ByteStorage")
    w.string("f"), w.function()
    w.string("g"), w.function(recur=True)
    out.append(w)
    # an nn module object holding a conv
    w = fx.ByteWriter()
    fx._write_conv(w, 3, 8, 3, 1, 1, rng, legacy=False)
    out.append(w)
    return out


def test_reader_matches_jax_on_hand_built_bytes(fixtures):
    for w in _streams(fixtures):
        data = bytes(w.buf)
        _same(tt7._Reader(data).read_object(), jt7._Reader(data).read_object())
    with pytest.raises(ValueError, match="truncated"):
        tt7._Reader(bytes(_streams(fixtures)[0].buf)[:-3]).read_object()
    with pytest.raises(ValueError, match="unknown t7 record type"):
        tt7._Reader(np.int32(42).tobytes()).read_object()


def test_writer_bytes_match_jax(t7_tests, tmp_path):
    ckpt, _ = t7_tests._reference_style_checkpoint(np.random.default_rng(1))
    jt7.save_t7(str(tmp_path / "j.t7"), ckpt)
    # the same object tree in the port's classes
    def port(obj):
        if isinstance(obj, jt7.TorchObject):
            return tt7.TorchObject(obj.torch_typename, port(obj.attrs))
        if isinstance(obj, dict):
            return {k: port(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [port(v) for v in obj]
        return obj
    tt7.save_t7(str(tmp_path / "t.t7"), port(ckpt))
    assert open(tmp_path / "t.t7", "rb").read() == open(tmp_path / "j.t7", "rb").read()
    _same(tt7.load_t7(str(tmp_path / "j.t7")), jt7.load_t7(str(tmp_path / "j.t7")))


@pytest.mark.parametrize("legacy", [False, True])
def test_import_stylizer_matches_jax(t7_tests, tmp_path, legacy):
    """A reference-shaped checkpoint (t7 round trip, legacy class-name
    headers too): the same spec, the same parameters, and the same
    stylized output."""
    ckpt, _ = t7_tests._reference_style_checkpoint(np.random.default_rng(2))
    path = str(tmp_path / "m.t7")
    jt7.save_t7(path, ckpt)
    data = open(path, "rb").read()
    if legacy:
        # the legacy header: the class name in place of the version string
        data = data.replace(b"\x03\x00\x00\x00V 1", b"")
    jspec, jparams = jt7.import_stylizer(jt7._Reader(data).read_object())
    tspec, tparams = tt7.import_stylizer(tt7._Reader(data).read_object(), device="cpu")
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    _, nparams = tt7.import_stylizer_numpy(tt7._Reader(data).read_object())
    assert sorted(nparams) == sorted(jparams)
    for layer in jparams:
        for leaf, v in jparams[layer].items():
            if isinstance(v, dict):
                continue
            np.testing.assert_array_equal(nparams[layer][leaf], np.asarray(v))
            want = np.asarray(v)
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(tparams[layer][leaf].numpy(), want)
    x = np.random.default_rng(3).standard_normal((1, 20, 20, 7)).astype(np.float32)
    want = np.asarray(jsty.apply(jparams, jspec, jnp.asarray(x)))
    got = tsty.apply(tparams, tspec, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_import_stylizer_rejects_unknown_modules():
    seq = tt7.TorchObject("nn.Sequential", {"modules": [tt7.TorchObject("nn.Mystery", {})]})
    with pytest.raises(ValueError, match="unsupported module"):
        tt7.import_stylizer(seq, device="cpu")


def test_convert_model_file_and_cli_match_jax(t7_tests, tmp_path):
    ckpt, _ = t7_tests._reference_style_checkpoint(np.random.default_rng(4))
    t7_path = str(tmp_path / "m.t7")
    jt7.save_t7(t7_path, ckpt)
    assert timport.main(["model", t7_path, str(tmp_path / "t.npz")]) == 0
    assert jimport.main(["model", t7_path, str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    # the port's own checkpoint loader reads it; the JAX loader reads the port's file
    spec, params, meta = tckpt.load_model(str(tmp_path / "t.npz"), device="cpu")
    jspec, _, jmeta = jckpt.load_model(str(tmp_path / "t.npz"))
    assert meta == jmeta and meta["imported_from"] == t7_path and spec.input_pad == 4
    y = tsty.apply(params, spec, torch.zeros(1, 16, 16, 7))
    assert tuple(y.shape) == (1, 16, 16, 3)


def test_import_vgg16_and_cli_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    mods = []
    for spec in ((3, 64), None, (64, 64), None, "pool", (64, 128)):
        if spec is None:
            mods.append(jt7.TorchObject("cudnn.ReLU", {}))
        elif spec == "pool":
            mods.append(jt7.TorchObject("nn.SpatialMaxPooling", {"kW": 2, "kH": 2}))
        else:
            i, o = spec
            mods.append(jt7.TorchObject("cudnn.SpatialConvolution", {
                "weight": rng.normal(size=(o, i * 9)).astype(np.float32),
                "bias": rng.normal(size=o), "nInputPlane": i, "nOutputPlane": o,
                "kW": 3, "kH": 3, "dW": 1, "dH": 1, "padW": 1, "padH": 1}))
    path = str(tmp_path / "vgg16.t7")
    jt7.save_t7(path, {"model": jt7.TorchObject("nn.Sequential", {"modules": mods})})
    want = jt7.import_vgg16(jt7.load_t7(path))
    got = tt7.import_vgg16(tt7.load_t7(path))
    assert sorted(got) == sorted(want) == ["conv01", "conv03", "conv06"]
    for layer in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[layer][leaf], want[layer][leaf])
    assert timport.main(["vgg", path, str(tmp_path / "t.npz")]) == 0
    assert jimport.main(["vgg", path, str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
