"""The harness finds configurations, cells, count modules, op counters and
metric readers by file name: a cell, a metric, or a configuration of another
family with its counts, added as new files, runs without an edit."""

import json
import shutil
import subprocess
import sys

import pytest

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


# A configuration of another family, a count module, an op counter bound by
# its operations and the op's roofline reader, as a later PR would add them.
MLP_CONFIG = {"name": "mlp_toy", "counts": "mlp_toy", "network": {"hidden_dims": [64, 64]},
              "env": {"obs_dim": 4, "num_actions": 2}, "learner": {"batch_size": 1024},
              "precision": {"act": "float32"}}
MLP_COUNTS = '''
def dims(config):
    return [config["env"]["obs_dim"], *config["network"]["hidden_dims"],
            config["env"]["num_actions"]]


def forward_flops(config):
    d = dims(config)
    return sum(2 * a * b for a, b in zip(d, d[1:]))


def learn_flops(config):
    d = dims(config)
    layers = [2 * a * b for a, b in zip(d, d[1:])]
    passes = sum((4 if i else 3) * f for i, f in enumerate(layers))
    return {"dense": config["learner"]["batch_size"] * passes}
'''
OP_COUNTER = '''
WEIGHTS = 4 * 64 + 64 + 64 * 64 + 64 + 64 * 2 + 2


def nbytes(args, kwargs):
    x = args[0]
    return 4 * (x.shape[0] * (4 + 2) + WEIGHTS)


def flops(args, kwargs):
    return 2 * args[0].shape[0] * (4 * 64 + 64 * 64 + 64 * 2), "float32"
'''
ROOFLINE_READER = '''
from portbench.core import readers


def read(r):
    return readers.roofline(r, "toy_mlp")
'''
READ_IN_COPY = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import portbench
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
import torch
from portbench.core import specs, trace
from portbench.core.cell import Readings
from portbench.core.spans import OP_PREFIX, Spans

out = {}
for rows in (131072, 1):
    spans = Spans(specs.byte_counter, specs.flop_counter)
    op = spans._wrap(OP_PREFIX + "toy_mlp", lambda x: x, specs.byte_counter("toy_mlp"),
                     specs.flop_counter("toy_mlp"))
    for _ in range(3):
        op(torch.empty(rows, 4))
    profile = trace.Profile(wall_s=1e-3, ops=[
        trace.DeviceOp("fused_mlp", 0, 3 * 40_000, ("op:toy_mlp",))], runtime_calls=3)
    r = Readings(config=specs.load_json(specs.BENCH_DIR / "configs" / "mlp_toy.json"),
                 window_s=2.0, vector_steps=100, learns=10, env_steps=100 * rows, host_s={},
                 profile=profile, device_profile=profile, op_bytes=dict(spans.op_bytes),
                 op_flops=dict(spans.op_flops), tf32={"matmul": True, "cudnn": False})
    out[rows] = {"mfu": specs.metric_reader("device.mfu")(r),
                 "roofline": specs.metric_reader("toy_mlp_roofline")(r)}
print(json.dumps(out))
'''


def test_config_of_another_family_and_an_op_bound_kernel_in_a_copy(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(specs.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    json.dump(MLP_CONFIG, open(bench / "configs" / "mlp_toy.json", "w"))
    (bench / "counts" / "mlp_toy.py").write_text(MLP_COUNTS)
    (bench / "counts" / "toy_mlp.py").write_text(OP_COUNTER)
    (bench / "metrics" / "toy_mlp_roofline.py").write_text(ROOFLINE_READER)
    assert all((bench / rel).read_bytes() == data for rel, data in before.items())

    proc = subprocess.run([sys.executable, "-c", READ_IN_COPY, str(tmp_path)],
                          capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = {int(k): v for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}

    # 4 -> 64 -> 64 -> 2: 4480 multiply-adds a row. The act at float32, the
    # learn's dense layers at TF32 (the matmul flag is on).
    fwd = 2 * 4480
    learn = 1024 * 2 * (3 * 4 * 64 + 4 * 64 * 64 + 4 * 64 * 2)
    device_s = 3 * 40_000 / 1e9
    for rows in (131072, 1):
        act_s = 100 * rows * fwd / 67e12
        assert got[rows]["mfu"] == pytest.approx(100 * (act_s + 10 * learn / 495e12) / 2.0,
                                                 rel=1e-12)
        ops_s = 3 * rows * fwd / 67e12
        bytes_s = 3 * 4 * (rows * 6 + 4610) / 3.35e12
        assert got[rows]["roofline"] == pytest.approx(100 * max(ops_s, bytes_s) / device_s,
                                                      rel=1e-12)
    # 131072 rows are bound by their operations (17.5 us a call, not the
    # bytes' 0.94 us); one row by its bytes (the weights).
    assert 3 * 131072 * fwd / 67e12 > 3 * 4 * (131072 * 6 + 4610) / 3.35e12
    assert 3 * fwd / 67e12 < 3 * 4 * (6 + 4610) / 3.35e12
    assert got[131072]["roofline"] == pytest.approx(100 * 3 * 131072 * fwd / 67e12 / device_s)
