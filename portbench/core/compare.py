"""What every reference's comparison shares: the verdict over the numbers
compared, and the helpers they are computed with.

Each reference module (`reference/<name>.py`) exports `judge(...)`, which
runs the reference over the run's seeds and returns the numbers compared,
and `checks(learn)`, their names; each cell's file gives their limits.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; a number with no limit fails."""
    return all(name in limits and values[name] <= limits[name] for name in values)


def leaf_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
              keep: Optional[Sequence[bool]] = None) -> List[Optional[float]]:
    """Each leaf's |norm_program - norm_reference| over the larger of its
    reference norm and the median leaf's; None for a leaf left out."""
    ref_n = [float(r.double().norm()) for r in ref]
    prog_n = [float(p.double().norm()) for p in prog]
    floor = statistics.median(ref_n)
    return [abs(pn - rn) / max(rn, floor, 1e-30) if keep is None or keep[i] else None
            for i, (pn, rn) in enumerate(zip(prog_n, ref_n))]


def worst(gaps: Sequence[Optional[float]]) -> float:
    kept = [g for g in gaps if g is not None]
    return max(kept) if kept else 0.0


def moved_leaves(grads: Sequence[torch.Tensor]) -> List[bool]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = [float(g.double().norm()) for g in grads]
    med = statistics.median(norms)
    return [n >= 1e-3 * med for n in norms]


def print_vector(seed: int, size: int, device) -> torch.Tensor:
    """Unit-norm normal weights of a frame print, drawn from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(size, generator=gen, device=device, dtype=torch.float64) / math.sqrt(size)


def frame_print(x: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """The print of each frame of `x` (N, ...): its values, flattened, dotted
    with `vector` in float64. Equal frames print alike; one element that
    differs by d moves the print by d times its weight. A print stands for a
    frame that the run overwrites before the reference can read it."""
    return x.reshape(x.shape[0], -1).double() @ vector
