"""The reference's UCI contextual-bandit benchmark protocol, end to end, on
the port (the twin of examples/cb_benchmark.py).

Runs SquareCB / FastCB over NeuralBandit and UCB / Thompson over
NeuralLinearBandit (binary action embeddings, gamma = 10*sqrt(T*d)) for T
online interactions on letter / pendigits / satimage / yeast, then the
offline uniform-logging-policy protocol. With no --data-dir it uses the
bundled deterministic UCI-shaped dataset twins
(pearl_tpu_torch/benchmarks/cb_datasets.py) and downloads nothing; point
--data-dir at a directory with the real UCI files (letter-recognition.data,
pendigits.tra, sat.trn, yeast.data) to run on real data.

Run from the repository's root:
    python -m examples_torch.cb_benchmark [--data-dir DIR] [--t 5000]
"""

import argparse

from pearl_tpu_torch.benchmarks.cb import (
    CB_DATASETS,
    run_cb_benchmark_suite,
    run_offline_cb_experiment,
)


def main(device=None, data_dir=None, t=5000, skip_offline=False):
    """(the online suite's results, the offline protocol's by dataset)."""
    results = run_cb_benchmark_suite(T=t, data_dir=data_dir, verbose=True, device=device)
    offline = {}
    if not skip_offline:
        for ds in CB_DATASETS:
            out = offline[ds] = run_offline_cb_experiment(ds, data_dir=data_dir, device=device)
            print(
                f"offline {ds:10s} source={out['source']} "
                f"avg_regret={out['final_avg_regret']:.3f}"
            )
    return results, offline


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--t", type=int, default=5000)
    p.add_argument("--skip-offline", action="store_true")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
