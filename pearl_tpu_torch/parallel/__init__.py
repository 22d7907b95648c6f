"""Distribution layer (port of `pearl_tpu/parallel/`).

- `data` axis (`data_parallel`): env and replay shards per rank, the learner
  replicated, its gradients (and LinUCB's additive statistics) averaged or
  summed over `torch.distributed` process groups (`utils.collectives`).
- `model` axis (`ensemble_parallel`): BootstrappedDQN's K members sharded
  over the ranks of a 2-D (data, model) mesh.
- `multihost`: joining a world of processes on one host or many.

As in the reference, data parallelism is the axis that scales this workload
(RL agents over small MLPs); tensor, pipeline and sequence parallelism of
the tiny networks are out of scope.
"""

from pearl_tpu_torch.parallel import multihost
from pearl_tpu_torch.parallel.data_parallel import (
    DataParallelRunner,
    Mesh,
    make_mesh,
    replica_spread,
    reshard_agent_state,
)
from pearl_tpu_torch.parallel.ensemble_parallel import (
    gather_ensemble_state,
    make_2d_mesh,
    make_ensemble_sharded_learn_batch,
    split_ensemble_state,
)
from pearl_tpu_torch.utils.collectives import MeshAxis, pmean, psum

__all__ = [
    "DataParallelRunner",
    "Mesh",
    "MeshAxis",
    "gather_ensemble_state",
    "make_2d_mesh",
    "make_ensemble_sharded_learn_batch",
    "make_mesh",
    "multihost",
    "pmean",
    "psum",
    "replica_spread",
    "reshard_agent_state",
    "split_ensemble_state",
]
