"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, bounds, and every file a name points to."""

import json
import re

import pytest

from portbench.core import specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = specs.benchmark()


def one_line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert (specs.ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(kind, keys):
    entries = BENCH[kind]
    assert 1 <= len(entries) <= 24
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) == keys
        assert NAME.match(e["name"]) and one_line(e["why"])


def test_configs_and_cells_point_at_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (specs.ROOT / c["file"]).is_file()
        assert one_line(c["source"]) and len(c["reduced"]) <= 16
        assert json.load(open(specs.ROOT / c["file"]))["name"] == c["name"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = specs.load_cell(w["name"])
        assert cell.workload["config"] == w["config"] and cell.workload["traffic"] == w["traffic"]
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e, per_layer = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    names = [m["name"] for m in e2e + per_layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in e2e}
    e2e_names = {m["name"] for m in e2e}
    layers = {}
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert (specs.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert (specs.BENCH_DIR / "counts" / f"{m['name'][:-len('_roofline')]}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert any("mfu" in m["name"].split(".") for m in per_layer)
    for m in e2e + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        reported = {m["name"] for m in specs.cell_metrics(BENCH, cell, "per_layer")}
        assert reported, cell
        assert {m["name"] for m in specs.cell_metrics(BENCH, cell, "end_to_end")} == e2e_names


def test_cells_state_their_limits():
    import importlib

    for w in BENCH["workloads"]:
        cell = specs.load_cell(w["name"])
        reference = importlib.import_module(f"portbench.reference.{cell.config['reference']}")
        assert set(cell.limits) == set(reference.checks(cell.traffic["learn"]))
