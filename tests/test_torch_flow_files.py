"""The port's flow-file tools (fast_artistic_videos_tpu_torch: cli.make_opt_flow,
cli.make_occlusions, cli.make_flow_list, and cli.stylize_video_file
--flow_background) against the JAX package's, on the same seeded frames and
the bundled flow weights, on the CPU. Tolerances: .flo files within 1e-3 px
(the flow tests' bound, tests/test_torch_flow.py), .pgm reliability maps
equal on at least 99.5% of the pixels (the same file's bar), the job lists
of make_flow_list identical."""

import os
import stat
import sys

import numpy as np
import pytest

from fast_artistic_videos_tpu.cli import make_flow_list as jlist
from fast_artistic_videos_tpu.cli import make_occlusions as jocc
from fast_artistic_videos_tpu.cli import make_opt_flow as jflow
from fast_artistic_videos_tpu.core import io
from fast_artistic_videos_tpu_torch.cli import make_flow_list as tlist
from fast_artistic_videos_tpu_torch.cli import make_occlusions as tocc
from fast_artistic_videos_tpu_torch.cli import make_opt_flow as tflow
from fast_artistic_videos_tpu_torch.cli import stylize_video as tcli
from fast_artistic_videos_tpu_torch.cli import stylize_video_file as tfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("forward_{j}_{i}.flo", "backward_{i}_{j}.flo", "reliable_{i}_{j}.pgm",
         "reliable_{j}_{i}.pgm")


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """The 2D parity fixture's first 3 frames (96x128, a (3, 2) px pan)."""
    d = tmp_path_factory.mktemp("frames")
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_parity_demo.npz")) as z:
        for t, f in enumerate(z["frames"][:3], 1):
            io.write_ppm(str(d / f"frame_{t:05d}.ppm"), f)
    return d


def _same_flow_files(a, b, pairs):
    for j, i in pairs:
        for name in NAMES:
            fa, fb = os.path.join(a, name.format(i=i, j=j)), os.path.join(b, name.format(i=i, j=j))
            if name.endswith(".flo"):
                assert np.abs(io.read_flo(fa) - io.read_flo(fb)).max() <= 1e-3, fa
            else:
                assert (io.read_pnm(fa) == io.read_pnm(fb)).mean() >= 0.995, fa


def test_make_opt_flow_matches_jax(frames_dir, tmp_path):
    args = ["--input_pattern", str(frames_dir / "frame_%05d.ppm"), "--flow_model", "bundled"]
    assert jflow.main(args + ["--out_dir", str(tmp_path / "j")]) == 0
    assert tflow.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    _same_flow_files(str(tmp_path / "t"), str(tmp_path / "j"), [(1, 2), (2, 3)])
    # the pan's backward flow is close to its ground truth (3, 2) away from the edges
    bwd = io.read_flo(str(tmp_path / "t" / "backward_3_2.flo"))[16:-16, 16:-16]
    assert np.abs(np.median(bwd.reshape(-1, 2), axis=0) - (3, 2)).max() < 0.5
    # --no_structure, and --skip_existing leaves the files alone
    before = os.path.getmtime(str(tmp_path / "t" / "backward_2_1.flo"))
    assert tflow.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert os.path.getmtime(str(tmp_path / "t" / "backward_2_1.flo")) == before
    assert jflow.main(args + ["--out_dir", str(tmp_path / "jn"), "--no_structure"]) == 0
    assert tflow.main(args + ["--out_dir", str(tmp_path / "tn"), "--device", "cpu",
                              "--no_structure"]) == 0
    _same_flow_files(str(tmp_path / "tn"), str(tmp_path / "jn"), [(1, 2), (2, 3)])


def _fake_flow_cmd(tmp_path):
    """An external estimator for --flow_cmd: writes a seeded .flo for the
    pair it is given."""
    script = tmp_path / "fake_flow.py"
    script.write_text(
        "import sys, zlib, numpy as np\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from fast_artistic_videos_tpu_torch.core import io\n"
        "a, b, out = sys.argv[1:4]\n"
        "seed = zlib.crc32((a + b).encode())\n"
        "io.write_flo(out, np.random.default_rng(seed).standard_normal((96, 128, 2))"
        ".astype(np.float32))\n")
    return f"{sys.executable} {script} {{a}} {{b}} {{out}}"


def test_make_opt_flow_flow_cmd_matches_jax(frames_dir, tmp_path):
    cmd = _fake_flow_cmd(tmp_path)
    args = ["--input_pattern", str(frames_dir / "frame_%05d.ppm"), "--flow_cmd", cmd]
    assert jflow.main(args + ["--out_dir", str(tmp_path / "j")]) == 0
    assert tflow.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    _same_flow_files(str(tmp_path / "t"), str(tmp_path / "j"), [(1, 2), (2, 3)])


def test_make_opt_flow_needs_a_flow_source(tmp_path):
    with pytest.raises(SystemExit):
        tflow.main(["--input_pattern", str(tmp_path / "f_%05d.ppm"), "--out_dir",
                    str(tmp_path), "--device", "cpu"])


def _scenes(root, rng):
    """Two scenes of flow pairs: 1<->2 and the tuple-start pair s_3<->s_4."""
    for scene in ("a", "b"):
        d = root / scene / "flow"
        d.mkdir(parents=True)
        for prefix, (i, j) in (("", (1, 2)), ("s_", (3, 4))):
            fwd = (rng.standard_normal((30, 40, 2)) * 1.5).astype(np.float32)
            bwd = -fwd + (rng.standard_normal((30, 40, 2)) * 0.3).astype(np.float32)
            io.write_flo(str(d / f"{prefix}{i}_{j}.flo"), fwd)
            io.write_flo(str(d / f"{prefix}{j}_{i}.flo"), bwd)
    (root / "not_a_scene.txt").write_text("")


def test_make_occlusions_matches_jax(tmp_path):
    for side in ("j", "t"):
        _scenes(tmp_path / side, np.random.default_rng(1))
    assert jocc.main([str(tmp_path / "j")]) == 0
    assert tocc.main([str(tmp_path / "t"), "--device", "cpu"]) == 0
    for scene in ("a", "b"):
        for name in ("reliable_1_2.pgm", "reliable_2_1.pgm", "reliable_s_3_4.pgm",
                     "reliable_s_4_3.pgm"):
            got = io.read_pnm(str(tmp_path / "t" / scene / "flow" / name))
            want = io.read_pnm(str(tmp_path / "j" / scene / "flow" / name))
            assert (got == want).mean() >= 0.995, (scene, name)


def test_make_occlusions_native_calls_the_checker_as_jax_does(tmp_path):
    """--native runs the shared C++ checker (fwd, bwd, out) in both: a stub
    checker records its arguments."""
    _scenes(tmp_path / "s", np.random.default_rng(2))
    stub = tmp_path / "checker.sh"
    stub.write_text('#!/bin/sh\necho "$@" >> "$(dirname "$0")/calls.txt"\ntouch "$3"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    assert jocc.main([str(tmp_path / "s"), "--native", str(stub)]) == 0
    jcalls = (tmp_path / "calls.txt").read_text()
    (tmp_path / "calls.txt").unlink()
    assert tocc.main([str(tmp_path / "s"), "--native", str(stub)]) == 0
    assert (tmp_path / "calls.txt").read_text() == jcalls and jcalls.count("\n") == 8


def test_make_flow_list_matches_jax(tmp_path):
    for side in ("j", "t"):
        for scene, n in (("s1", 7), ("s2", 3), ("s3", 1)):
            d = tmp_path / side / "scenes" / scene
            d.mkdir(parents=True)
            r = np.random.default_rng(len(scene) + n)
            for k in range(1, n + 1):
                io.write_ppm(str(d / f"frame_{k:05d}.ppm"),
                             (r.random((8, 10, 3)) * 255).astype(np.uint8))
    for side, mod in (("j", jlist), ("t", tlist)):
        assert mod.main([str(tmp_path / side / "scenes"), str(tmp_path / side / "jobs.txt"),
                         "2", "3", "--frames_ready", "--delete_unused"]) == 0
    jobs = [line.replace(str(tmp_path / "j"), "") for line in
            (tmp_path / "j" / "jobs.txt").read_text().splitlines()]
    tjobs = [line.replace(str(tmp_path / "t"), "") for line in
             (tmp_path / "t" / "jobs.txt").read_text().splitlines()]
    assert tjobs == jobs and len(jobs) == 6
    for scene in ("s1", "s2", "s3"):
        assert (sorted(os.listdir(tmp_path / "t" / "scenes" / scene))
                == sorted(os.listdir(tmp_path / "j" / "scenes" / scene)))


def test_stylize_video_file_flow_background(frames_dir, tmp_path):
    """--flow_background: the port's make_opt_flow in a concurrent process on
    --device writes the flow files, the stylizer polls for them; the frames
    equal the port's stylize CLI run on the files the producer wrote, and
    the files equal a direct make_opt_flow run."""
    import shutil

    frames = tmp_path / "frames"
    shutil.copytree(str(frames_dir), str(frames))
    assert tfile.main(["--frames_dir", str(frames), "--model_vid", "demo",
                       "--flow_model", "bundled", "--flow_background", "--dtype", "float32",
                       "--out_dir", str(tmp_path / "w"), "--device", "cpu"]) == 0
    flow_dir = tmp_path / "w" / "flow"
    assert tflow.main(["--input_pattern", str(frames / "frame_%05d.ppm"), "--flow_model",
                       "bundled", "--out_dir", str(tmp_path / "direct"), "--device", "cpu"]) == 0
    _same_flow_files(str(flow_dir), str(tmp_path / "direct"), [(1, 2), (2, 3)])
    tcli.main(["--input_pattern", str(frames / "frame_%05d.ppm"), "--model_vid", "demo",
               "--flow_pattern", str(flow_dir / "backward_[%d]_{%d}.flo"),
               "--occlusions_pattern", str(flow_dir / "reliable_[%d]_{%d}.pgm"),
               "--output_prefix", str(tmp_path / "ref" / "o"), "--device", "cpu"])
    for t in (1, 2, 3):
        got = io.load_image_u8(str(tmp_path / "w" / f"out-{t:05d}.png"))
        want = io.load_image_u8(str(tmp_path / "ref" / f"o-{t:05d}.png"))
        np.testing.assert_array_equal(got, want)
        assert got.std() > 1.0
