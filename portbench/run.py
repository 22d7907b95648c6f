"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with `--trace 1`)
and, last, `checks`: each number compared with its limit, which also end
standard error. `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer ones. Needs a CUDA device: without one, or with
fewer than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Compile caches at fixed paths inside the checkout (the port's own nvcc
# builds already live under build/pearl_tpu_torch).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pearl_tpu"}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench.core import cell as cell_mod
    from portbench.core import specs

    bench = specs.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = specs.load_cell(args.workload)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    names = {kind: [m["name"] for m in specs.cell_metrics(bench, args.workload, kind)]
             for kind in ("end_to_end", "per_layer")}
    torch.cuda.reset_peak_memory_stats()
    out = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, names)

    result = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {n: {"value": v, "unit": units[n]} for n, v in out["metrics"].items()},
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": entry["chips"],
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    readings = out["readings"]
    if args.trace:
        dev, host = readings.device_profile, readings.profile
        if dev is None or dev.busy_s <= 0 or host is None:
            print("the profiler saw no device activity", file=sys.stderr)
            return 3
        result["device"]["busy_s"] = dev.busy_s
        result["device"]["window_s"] = dev.wall_s
        result["breakdown"] = {"device_ops": dev.top_ops(10), "idle_gaps": host.idle_gaps(10)}
    result["checks"] = out["checks"]

    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, check in out["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
