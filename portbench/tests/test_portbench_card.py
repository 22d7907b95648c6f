"""On the card: one short run of each cell through the command, correct and
with every metric the cell reports. Skipped without a CUDA device."""

import json
import subprocess
import sys

import pytest

from portbench.core import specs

from conftest import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_card(card, name, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in specs.cell_metrics(specs.benchmark(), name, kind)}
    assert set(result["metrics"]) == wanted
    assert list(result)[-1] == "checks"
