"""The control: the plain reference put in the program's place, computed one
precision below what the configuration states, and judged by the same
comparison as the program. It has to come out not correct. With `--fault`
the stand-in runs at the configuration's precision with a fault planted
instead (the faults are the reference's `FAULTS`).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--fault half_batch]

Prints one JSON line a seed with each number compared. The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.core import compare, specs  # noqa: E402
from portbench.core.cell import (  # noqa: E402
    call_seed, check_envs, print_seed, setup_dispatches, weight_seed,
)


def control(cell: specs.Cell, seed: int, device, fault: str = "none") -> dict:
    """The numbers compared for the control of `cell` at `seed` (or, with
    `fault`, for the stand-in with that fault), at the cell's own size and
    over the same set-up dispatches as a run."""
    cfg, traffic = cell.config, cell.traffic
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    spec = reference.Spec.from_config(cfg)
    fill = setup_dispatches(cfg, traffic)
    seeds = [call_seed(seed, i) for i in range(fill)]
    init = reference.init_weights(spec, weight_seed(seed), device)
    keep, stage = reference.judged_learns(spec, traffic, fill)
    envs = check_envs(seed, traffic["num_envs"], traffic["check_envs"], device)
    prog = reference.stand_in(spec, cfg, traffic, seeds, print_seed(seed), init, device, envs,
                              keep, stage, fault)
    return reference.judge(spec, traffic, seeds, print_seed(seed), prog, init, device)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fault", default="none")
    args = parser.parse_args()
    cell = specs.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = control(cell, seed, args.device, args.fault)
        verdict = compare.verdict(values, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": verdict, "values": values, "limits": cell.limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
