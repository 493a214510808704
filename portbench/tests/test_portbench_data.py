"""The benchmark's data layout, frames and import checks, on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.harness import frames, guard, spec  # noqa: E402

BENCH = os.path.join(ROOT, "portbench")


def _copy_tree(tmp):
    """A checkout holding BENCHMARK.json and portbench/ alone."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp


def test_a_config_a_traffic_mix_a_metric_and_a_cell_are_found_by_name(tmp_path):
    root = _copy_tree(tmp_path)
    bench = root / "portbench"
    harness_before = {p: (bench / "harness" / p).read_bytes()
                      for p in os.listdir(bench / "harness") if p.endswith(".py")}
    cfg = json.loads((bench / "configs" / "canonical-1080p.json").read_text())
    cfg["geometry"] = {"kind": "frame", "height": 2160, "width": 3840}
    cfg["flow"]["scale"] = 0.25
    (bench / "configs" / "canonical-2160p.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fast-pan.json").write_text(json.dumps(
        {"entry": "video_driver", "streams": 1, "pan": [24, 6], "warmup_frames": 4,
         "check": {"every": 8}}))
    (bench / "metrics" / "frames_in_trace.py").write_text(
        "def read(ctx):\n    return float(ctx.landed)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "canonical-2160p", "source": "https://example.org",
                         "file": "portbench/configs/canonical-2160p.json", "reduced": [],
                         "why": "4K"})
    b["workloads"].append({"name": "canonical-2160p.fast-pan", "config": "canonical-2160p",
                           "traffic": "fast-pan", "chips": 1, "why": "a wide band"})
    b["per_layer"].append({"name": "frames_in_trace", "unit": "frames", "better": "higher",
                           "source": "host_clock", "layer": "device", "moves": "frames_per_s",
                           "workloads": ["canonical-2160p.fast-pan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.cell("canonical-2160p.fast-pan", root=str(root), bench_dir=str(bench))
    assert cell.config["geometry"]["width"] == 3840
    assert cell.traffic["pan"] == [24, 6]
    assert [m["name"] for m in cell.per_layer][-1] == "frames_in_trace"
    read = spec.readers(cell.per_layer, bench_dir=str(bench))["frames_in_trace"]

    class Ctx:
        landed = 7
    assert read(Ctx()) == 7.0
    assert {p: (bench / "harness" / p).read_bytes() for p in harness_before} == harness_before


def test_every_cell_of_the_benchmark_resolves_and_every_metric_has_a_reader():
    b = spec.benchmark()
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.traffic["entry"] in ("video_driver", "vr_driver", "stream_pool")
        assert spec.limits(w["name"]) is not None
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in b["per_layer"]}
    assert names == {os.path.splitext(f)[0] for f in os.listdir(os.path.join(BENCH, "metrics"))
                     if f.endswith(".py")}


@pytest.mark.parametrize("step", [(6, 3), (8, 2)])
def test_pans_are_set_by_the_seed_and_move_by_their_step(step):
    a = frames.Source(2 ** 31 + 7, 300, period=512).pans(2, 120, 200, step)
    b = frames.Source(2 ** 31 + 7, 300, period=512).pans(2, 120, 200, step)
    c = frames.Source(2 ** 31 + 8, 300, period=512).pans(2, 120, 200, step)
    for t in (0, 1, 40, 200):
        assert np.array_equal(a[0].frame(t), b[0].frame(t))
        assert np.array_equal(a[1].frame(t), b[1].frame(t))
    assert not np.array_equal(a[0].frame(0), c[0].frame(0))
    assert not np.array_equal(a[0].frame(0), a[1].frame(0))
    dx, dy = step
    for t in (0, 5, 100):          # also across the texture's period
        f0, f1 = a[0].frame(t), a[0].frame(t + 1)
        assert f0.shape == (120, 200, 3) and f0.dtype == np.uint8
        # frame t+1 at (y, x) shows what frame t showed at (y + dy, x + dx)
        assert np.array_equal(f1[:-dy, :-dx], f0[dy:, dx:])


def test_the_texture_is_periodic():
    tex = frames.texture(3, period=256)
    src = frames.Source(3, 100, period=256)
    assert np.array_equal(src.canvas[:256, :256], tex)
    assert np.array_equal(src.canvas[256:356, :256], tex[:100])
    assert tex.min() == 0 and tex.max() == 255


def test_the_import_check_compares_whole_top_level_names():
    assert guard.found(["fast_artistic_videos_tpu_torch.video.engine", "torch",
                        "jaxtyping", "benchmark_tools"]) == []
    assert guard.found(["jax.numpy", "fast_artistic_videos_tpu.ops", "flax", "jaxlib",
                        "bench", "chip_smoke"]) == sorted(
        ["jax.numpy", "fast_artistic_videos_tpu.ops", "flax", "jaxlib", "bench", "chip_smoke"])
    assert guard.found(["fast_artistic_videos_tpu_torch.ops"],
                       guard.FORBIDDEN_IN_REFERENCE) == ["fast_artistic_videos_tpu_torch.ops"]


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_what_a_run_loads_holds_no_jax_and_no_jax_package():
    mods = _modules_after(
        "import portbench.harness.main, portbench.harness.entries, portbench.harness.tracing\n"
        "import portbench.harness.check, portbench.harness.work, portbench.harness.weights\n"
        "import fast_artistic_videos_tpu_torch.cli.stylize_video\n"
        "import fast_artistic_videos_tpu_torch.cli.stylize_vr_video\n"
        "import fast_artistic_videos_tpu_torch.video.serving\n"
        "import fast_artistic_videos_tpu_torch.models.checkpoint\n"
        "from portbench.harness import spec, tracing\n"
        "[spec.reader(m['name']) for m in spec.benchmark()['per_layer']]\n"
        "cfgs = [spec.cell(w['name']).config for w in spec.benchmark()['workloads']]\n"
        "[spec.flow_program(spec.flow_model(c)) for c in cfgs]\n"
        "[spec.flow_reference(spec.flow_model(c)) for c in cfgs]\n"
        "with tracing.Launches().recording():\n"
        "    pass")
    assert guard.found(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "reference"))
                   if f.endswith(".py") and f != "__init__.py")
    assert {"flow", "flow_pwclite", "stylizer", "video", "vr_maps"} <= set(names)
    mods = _modules_after("".join(f"import portbench.reference.{n}\n" for n in names))
    assert guard.found(mods, guard.FORBIDDEN_IN_REFERENCE) == []
