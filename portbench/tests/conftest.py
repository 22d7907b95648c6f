"""Test helpers: the repository root on the path, the cells of
`BENCHMARK.json` (`CELLS`; `PIXEL_CELLS`, those judged by the pixel DQN
reference), and a pixel cell cut to a size the CPU runs in seconds (4 envs, a
replay of 96 pushes, batch 32, two chunks a dispatch: widths, frames and
every other setting as the cell's)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import specs  # noqa: E402

CELLS = [w["name"] for w in specs.benchmark()["workloads"]]
PIXEL_CELLS = [name for name in CELLS
               if specs.load_cell(name).config["reference"] == "dqn_pixel"]


def tiny(cell: specs.Cell) -> specs.Cell:
    cell.config["replay"]["capacity"] = 4 * 96
    cell.config["learner"]["batch_size"] = 32
    cell.traffic.update(num_envs=4, chunks_per_dispatch=2, check_envs=4)
    return cell


@pytest.fixture
def tiny_cell():
    return lambda name: tiny(specs.load_cell(name))


@pytest.fixture
def card():
    """Skips unless a CUDA device is present: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return "cuda"
