"""What the harness and the reference load: no module whose top-level name,
compared whole, is jax, jaxlib, flax, optax or pearl_tpu; and the reference
nothing of pearl_tpu_torch."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'optax', 'pearl_tpu'}"

HARNESS = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import portbench.run, portbench.control
from portbench.core import cell, specs, trace, readers
from conftest import tiny
c = tiny(specs.load_cell("dqn2013_atari84.train"))
cell.run(c, 3, 0.2, True, "cpu", time.perf_counter(),
         {{"end_to_end": [], "per_layer": ["device.mfu"]}})
bad = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN})
assert not bad, bad
assert "pearl_tpu_torch" in sys.modules
"""

REFERENCE = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from portbench.core import specs
from portbench.reference import dqn_pixel as ref
import torch
spec = ref.Spec.from_config(specs.load_cell("nature_dqn_atari84.train").config)
spec = spec.__class__(**{{**spec.__dict__, "capacity": 64, "batch_size": 8}})
run = ref.simulate(spec, device="cpu", num_envs=2, steps_per_learn=4, chunks=2,
                   call_seeds=[1, 2], learn=True, params0=ref.init_weights(spec, 0, "cpu"))
assert len(run.losses) == 4
bad = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN} | {{"pearl_tpu_torch"}})
assert not bad, bad
"""


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_harness_loads_no_jax():
    _run(HARNESS)


def test_reference_loads_nothing_of_the_program():
    _run(REFERENCE)
