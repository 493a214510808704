"""The port's held-out flow evaluation, flow-training CLI and flow tools
(fast_artistic_videos_tpu_torch: flow.train.evaluate_heldout,
cli.train_flownet, tools/eval_flow_torch.py, tools/finetune_flow_torch.py)
against the JAX package's and the committed fixture
tests/fixtures/torch_parity_flow_eval.npz (the JAX function on the bundled
weights at 192 px, which chip_smoke.py phase 16 holds the card to).
Tolerances: EPE 1e-4 relative, pass rates 1e-3 absolute (a pass rate
counts the pixels on either side of the check's threshold)."""

import importlib.util
import os

import h5py
import numpy as np

from fast_artistic_videos_tpu.flow import estimator as jest
from fast_artistic_videos_tpu.flow import train as jtrain
from fast_artistic_videos_tpu_torch.cli import train_flownet
from fast_artistic_videos_tpu_torch.flow import estimator as test_
from fast_artistic_videos_tpu_torch.flow import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parity_flow_eval.npz")


def test_evaluate_heldout_matches_jax():
    jp, tp = jest.load_params("bundled"), test_.load_params("bundled", "cpu")
    want = jtrain.evaluate_heldout(jp, size=48, n_cases=1)
    got = ttrain.evaluate_heldout(tp, size=48, n_cases=1)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k][:2], want[k][:2], rtol=1e-4)
        np.testing.assert_allclose(got[k][2:], want[k][2:], rtol=0, atol=1e-3)


def test_flow_eval_fixture_on_the_cpu():
    """The committed JAX evaluate_heldout results on the bundled weights
    (chip_smoke.py phase 16 holds the card to them) against the port on
    the CPU."""
    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    res = ttrain.evaluate_heldout(test_.load_params("bundled", "cpu"), size=int(fx["size"]),
                                  n_cases=int(fx["n_cases"]))
    got = np.asarray([res[str(p)] for p in fx["protocols"]])
    np.testing.assert_allclose(got[:, :2], fx["results"][:, :2], rtol=1e-4)
    np.testing.assert_allclose(got[:, 2:], fx["results"][:, 2:], rtol=0, atol=1e-3)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_and_tools_run_on_the_cpu(tmp_path, capsys):
    """cli/train_flownet.py (one iteration from an HDF5, --device cpu; its
    weights load in the JAX package), tools/eval_flow_torch.py and
    tools/finetune_flow_torch.py at tiny sizes."""
    h5 = str(tmp_path / "coco.h5")
    with h5py.File(h5, "w") as f:
        for split in ("train2014", "val2014"):
            f.create_dataset(f"/{split}/images", data=np.random.default_rng(10).integers(
                0, 256, (4, 3, 40, 40), dtype=np.uint8))
    out = str(tmp_path / "flow.npz")
    assert train_flownet.main(["--h5_file", h5, "--out", out, "--iterations", "1",
                               "--batch_size", "2", "--size", "32", "--resume", "bundled",
                               "--device", "cpu"]) == 0
    assert set(jest.load_params(out)) == set(jest.load_params("bundled"))
    assert _tool("eval_flow_torch").main(["--weights", out, "--size", "32", "--n_cases", "1",
                                          "--device", "cpu"]) == 0
    assert "natural" in capsys.readouterr().out
    code = _tool("finetune_flow_torch").main([
        "--iterations", "1", "--batch_size", "1", "--size", "32", "--eval_size", "32",
        "--eval_cases", "1", "--init", out, "--out", str(tmp_path / "ft.npz"), "--context",
        "--device", "cpu"])
    assert code in (0, 1) and os.path.exists(tmp_path / "ft.npz")
    assert "ctx_out" in jest.load_params(str(tmp_path / "ft.npz"))
