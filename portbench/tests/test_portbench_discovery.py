"""The harness finds configurations, cells and metric readers by file name:
a cell or a metric added as new files runs without an edit."""

import json
import shutil

from portbench.core import specs
from portbench.core.cell import Readings


def test_every_cell_loads():
    for w in specs.benchmark()["workloads"]:
        cell = specs.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.name == w["name"]


def test_throwaway_cell_and_metric_in_a_copy(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(specs.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.load(open(bench / "traffic" / "train.json"))
    traffic["num_envs"] = 1024
    json.dump(traffic, open(bench / "traffic" / "train_1024.json", "w"))
    json.dump({"name": "dqn2013_atari84.train_1024", "config": "dqn2013_atari84",
               "traffic": "train_1024", "chips": 1, "why": "a throwaway cell", "limits": {}},
              open(bench / "workloads" / "dqn2013_atari84.train_1024.json", "w"))
    (bench / "metrics" / "window.steps_per_s.py").write_text(
        "def read(r):\n    return r.vector_steps / r.window_s\n")
    cell = specs.load_cell("dqn2013_atari84.train_1024", bench)
    assert cell.traffic["num_envs"] == 1024 and cell.config["name"] == "dqn2013_atari84"
    r = Readings(config=cell.config, window_s=2.0, vector_steps=640, learns=80,
                 env_steps=640 * 1024, host_s={})
    assert specs.metric_reader("window.steps_per_s", bench)(r) == 320.0
    assert specs.byte_counter("copy_fence", bench) is not None
    assert specs.byte_counter("no_such_op", bench) is None


def test_cell_metrics_follow_workloads_key():
    bench = {"end_to_end": [{"name": "a"}], "per_layer": [
        {"name": "everywhere"}, {"name": "only_x", "workloads": ["x"]}]}
    assert [m["name"] for m in specs.cell_metrics(bench, "x", "per_layer")] == [
        "everywhere", "only_x"]
    assert [m["name"] for m in specs.cell_metrics(bench, "y", "per_layer")] == ["everywhere"]
