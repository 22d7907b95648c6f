"""Multi-process and multi-host start-up (port of
`pearl_tpu/parallel/multihost.py`).

`initialize` joins this process to a `torch.distributed` world; `global_mesh`
is then a mesh over every rank of the job, on one host or many, and the
learners' collectives ride whatever the group provides (NVLink and the
network for NCCL, TCP for gloo).

Unlike the reference, which swallows any error of `jax.distributed.initialize`
and carries on alone, a process that is given a cluster (arguments or
torchrun's environment) and fails to join it raises: a rank that silently
trains alone would leave the others waiting in their first collective.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pearl_tpu_torch.parallel.data_parallel import Mesh, make_mesh

# What torchrun sets for every process it starts.
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the world: `coordinator_address` ("host:port" or an init URL
    such as "tcp://host:port" or "file:///path"), `num_processes` and this
    process's `process_id`; without arguments, from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). A no-op only when there
    are neither arguments nor that environment. `backend` None lets
    `torch.distributed` give CPU tensors gloo and CUDA tensors NCCL."""
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if not any(k in os.environ for k in TORCHRUN_ENV):
            return  # a single process: nothing to join
        dist.init_process_group(backend, init_method="env://")
        return
    if None in given:
        raise ValueError(
            "initialize takes coordinator_address, num_processes and process_id together"
        )
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


def global_mesh(axis: str = "data", *, device=None, backend: Optional[str] = None) -> Mesh:
    """A 1-D mesh over every rank of the job (all hosts)."""
    return make_mesh(None, axis, device=device, backend=backend)


def local_device_count() -> int:
    """The cards this process can see (1 on a machine without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def process_index() -> int:
    """This process's rank in the world (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0
