"""Finding the benchmark's parts by name.

A cell is `workloads/<cell>.json`; it names its configuration
(`configs/<config>.json`) and its traffic mix (`traffic/<traffic>.json`). A
per-layer metric is `metrics/<metric>.py`, a module with `read(trace)`; a
kernel's counter is `counts/<op>.py`, and the count module that a
configuration names under `"counts"` is `counts/<counts>.py`. `BENCHMARK.json`
at the root of the checkout says which metrics a cell reports. Nothing here
names a cell, a configuration or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{workload['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic, workload=workload)


def load_module(path: Path, name: Optional[str] = None):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def _op_counter(op: str, attr: str, bench_dir: Path):
    path = bench_dir / "counts" / f"{op}.py"
    if not path.exists():
        return None
    return getattr(load_module(path, f"portbench_count_{op}"), attr, None)


def byte_counter(op: str, bench_dir: Path = BENCH_DIR):
    """`nbytes(args, kwargs)` of `counts/<op>.py`, or None where the op has
    no counter."""
    return _op_counter(op, "nbytes", bench_dir)


def flop_counter(op: str, bench_dir: Path = BENCH_DIR):
    """`flops(args, kwargs)` of `counts/<op>.py`, which returns the call's
    operations and the key in `peaks.FLOPS` of the precision they run at; None
    where the op has no counter or its counter counts bytes only."""
    return _op_counter(op, "flops", bench_dir)


def count_module(config: dict):
    """The module `counts/<counts>.py` that the configuration names under
    `"counts"`: `forward_flops(config)`, the operations of one act row, and
    `learn_flops(config)`, one learn's operations by kind (`conv`, `dense`)."""
    name = config["counts"]
    return load_module(BENCH_DIR / "counts" / f"{name}.py", f"portbench_counts_{name}")


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The entries of `bench[kind]` ("end_to_end" or "per_layer") that cell
    `cell` reports: those without a `workloads` key and those listing it."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
