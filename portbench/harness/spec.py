"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``, a configuration's flow
family (``reference/flow_<model>.py`` and ``flows/<model>.py``) and the
hand-written kernels' work counts (``kernels/<group>.py``) under
``portbench/``. Adding a configuration, a traffic mix, a flow family, a
kernel's count, a per-layer metric or a cell adds files and entries; no
file of the harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    b = benchmark(root)
    found = [w for w in b["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = next(c for c in b["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in b["end_to_end"] if _applies(m, name)],
                [m for m in b["per_layer"] if _applies(m, name)])


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(ctx)`` of metrics/<metric>.py."""
    return _module(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                   f"portbench_metric_{metric}").read


def readers(metrics: List[dict], bench_dir: str = BENCH_DIR) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], bench_dir) for m in metrics}


def flow_model(config: dict) -> str:
    """The configuration's flow family: ``flow.model``, else PWC-lite."""
    return config["flow"].get("model", "pwclite")


def flow_reference(model: str, bench_dir: str = BENCH_DIR):
    """The reference's half of a flow family: reference/flow_<model>.py."""
    return _module(os.path.join(bench_dir, "reference", f"flow_{model}.py"),
                   f"portbench_flow_{model}")


def flow_program(model: str, bench_dir: str = BENCH_DIR):
    """The program's half of a flow family: flows/<model>.py."""
    return _module(os.path.join(bench_dir, "flows", f"{model}.py"),
                   f"portbench_flows_{model}")


def kernels(bench_dir: str = BENCH_DIR) -> Dict[str, object]:
    """{group: module} of kernels/<group>.py, by name."""
    d = os.path.join(bench_dir, "kernels")
    return {f[:-3]: _module(os.path.join(d, f), f"portbench_kernel_{f[:-3]}")
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def limits(cell_name: str, bench_dir: str = BENCH_DIR) -> Optional[dict]:
    path = os.path.join(bench_dir, "limits", f"{cell_name}.json")
    return load_json(path) if os.path.exists(path) else None
