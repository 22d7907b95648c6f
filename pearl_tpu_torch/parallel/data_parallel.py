"""Data parallelism over `torch.distributed` (port of
`pearl_tpu/parallel/data_parallel.py`).

One process per device, joined by a process group: gloo on the CPU, NCCL
where each rank has a GPU of its own, and gloo on CUDA tensors where several
ranks share one card (NCCL refuses two ranks on one device). Each rank holds

- its own env shard and replay shard, drawn from its own generator
  (`rank_seed`), and
- a replica of the learner (and safety) state, initialised from the SHARED
  seed on every rank and kept bit-identical by `pmean`-ing the gradients
  inside the learners (`pmean_axis`, set by `with_pmean_axis`).

The reference stacks the per-device states on a leading axis of one array
tree; here each process holds only its own state, and a state of the whole
mesh is the list of the ranks' states in rank order (`reshard_agent_state`
takes and returns such lists).

Launch: `torchrun --nproc_per_node=N script.py` (or
`multihost.initialize(...)` in each process), then `make_mesh(N)` on every
rank with the same arguments. `make_mesh(1)` in a process with no group
makes a world of one in-process, so a single process runs the same code path
(and, on a card, the same NCCL collectives) as each rank of a larger mesh;
that mesh owns the world, and its `close()` (or the end of a `with` block)
destroys it. A mesh over a world it did not make (torchrun's,
`multihost.initialize`'s, an earlier mesh's) leaves that world alone.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.utils.collectives import MeshAxis, broadcast_bytes, psum
from pearl_tpu_torch.utils.pytree import named_leaves
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass(eq=False)
class Mesh:
    """A mesh of ranks as this process sees it: the axes it belongs to
    (`axis(name)`), their sizes (`shape`), this rank's device and the
    backend. A rank of the world outside the mesh has `member` False.
    `world` is the default group when this mesh made it (a world of one),
    else None; `close()` destroys that group and nothing else."""

    axes: Dict[str, Optional[MeshAxis]]
    shape: Dict[str, int]
    device: torch.device
    backend: str
    world: Optional[object] = dataclasses.field(default=None, repr=False)

    def close(self) -> None:
        """Destroy the world this mesh made, if it is still the process's
        world; a no-op for a mesh over a world it did not make, and the
        second time."""
        world, self.world = self.world, None
        if world is not None and dist.is_initialized() and dist.group.WORLD is world:
            dist.destroy_process_group()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def member(self) -> bool:
        return all(a is not None for a in self.axes.values())

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def axis_names(self):
        return tuple(self.shape)

    def axis(self, name: str) -> MeshAxis:
        if name not in self.axes:
            raise ValueError(f"the mesh has axes {self.axis_names}, not {name!r}")
        if self.axes[name] is None:
            raise ValueError(f"rank {dist.get_rank()} of the world is not in this mesh")
        return self.axes[name]


def _launch_hint(n: int) -> str:
    return (
        f"launch {n} processes (torchrun --nproc_per_node={n} script.py, or "
        "pearl_tpu_torch.parallel.multihost.initialize(...) in each) before make_mesh"
    )


def _mesh_device(device: DeviceLike) -> torch.device:
    """`device`, else the card of this process's LOCAL_RANK (its global rank
    without one). The CPU only when asked for."""
    if device is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return resolve_device(device)


def _world(n: int, device: torch.device, backend: str):
    """(the world's size, the default group if this call made it, else
    None): a world of one is made in-process when there is none and `n` is
    1."""
    made = None
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"make_mesh needs a world of at least {n} ranks: {_launch_hint(n)}")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        made = dist.group.WORLD
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"a mesh of {n} ranks does not fit the world of {world}: {_launch_hint(n)}"
        )
    return world, made


def _group(ranks: List[int], world: int, backend: str):
    """The whole world's group when `ranks` is the world and its backend is
    `backend`, else a new group (every rank of the world must call this with
    the same arguments, in the same order)."""
    if ranks == list(range(world)) and dist.get_backend() == backend:
        return dist.group.WORLD
    return dist.new_group(ranks, backend=backend)


def _axis(name: str, ranks: List[int], group, device) -> Optional[MeshAxis]:
    me = dist.get_rank()
    if me not in ranks:
        return None
    return MeshAxis(name=name, group=group, size=len(ranks), rank=ranks.index(me), device=device)


def _setup(n: int, device: DeviceLike, backend: Optional[str]):
    device = _mesh_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return (device, backend, *_world(n, device, backend))


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "data", *,
    device: DeviceLike = None, backend: Optional[str] = None,
) -> Mesh:
    """A 1-D mesh of the world's first `n_devices` ranks (all of them by
    default). The device is `cuda:LOCAL_RANK` unless `device` names one; the
    backend NCCL for a CUDA device and gloo for the CPU unless `backend`
    names one (`backend="gloo"` with a CUDA device for ranks sharing a card).
    Every rank of the world calls it with the same arguments. A mesh that
    made a world of one closes it with `close()` or as a context manager."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    device, backend, world, made = _setup(n, device, backend)
    ranks = list(range(n))
    group = _group(ranks, world, backend)
    return Mesh(axes={axis: _axis(axis, ranks, group, device)}, shape={axis: n},
                device=device, backend=backend, world=made)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s own draws (env shard, exploration, replay
    samples): `seed` itself on rank 0, so that a mesh of one is the solo
    run, and a seed derived from (seed, rank) elsewhere."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1, np.uint64)[0] >> 1)


def replica_spread(tree, axis: MeshAxis) -> float:
    """The largest |x - x of rank 0| over the floating leaves of `tree` (a
    rank's learner params, say) and over every rank of `axis`: 0.0 when the
    replicas agree. Every rank of the axis calls it."""
    leaves = [leaf.to(axis.device) for _, leaf in named_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    theirs = broadcast_bytes(leaves, axis)
    spread = torch.zeros((), dtype=torch.float64, device=axis.device)
    for a, b in zip(leaves, theirs):
        if a.numel():
            spread = torch.maximum(spread, (a.double() - b.double()).abs().max())
    if axis.size > 1:
        dist.all_reduce(spread, op=dist.ReduceOp.MAX, group=axis.group)
    return float(spread)


def with_pmean_axis(agent: PearlAgent, axis: Optional[MeshAxis]) -> PearlAgent:
    """`agent` whose learner and safety module (where it has the field)
    average over `axis`."""
    agent = dataclasses.replace(
        agent, policy_learner=dataclasses.replace(agent.policy_learner, pmean_axis=axis)
    )
    if hasattr(agent.safety_module, "pmean_axis"):
        agent = dataclasses.replace(
            agent, safety_module=dataclasses.replace(agent.safety_module, pmean_axis=axis)
        )
    return agent


def reshard_agent_state(states: Sequence, n_devices: int) -> list:
    """The per-rank states of a run (a list in rank order) for a mesh of
    `n_devices` ranks: the checkpoint-restore path when a run resumes on
    fewer or more devices. Learner and safety replicas are identical on
    every rank, so any state serves. Replay shards are each rank's own
    data: shrinking keeps the first `n_devices` (the dropped transitions
    are lost; replay is re-fillable experience, not model state), growing
    reuses them cyclically (duplicate experience is benign under
    with-replacement sampling). Per-env leaves are rebuilt by
    `online_learning` when a state is passed with fresh envs. Every entry is
    a copy: no two share a tensor, a module or a generator."""
    states = list(states)
    if not states:
        raise ValueError("reshard_agent_state needs at least one state")
    return [copy.deepcopy(states[i % len(states)]) for i in range(n_devices)]


@dataclasses.dataclass(eq=False)
class DataParallelRunner:
    """One `step` is `steps_per_learn` vectorized env steps on this rank's
    shard and one learn whose gradients are averaged over the mesh axis;
    returns the mean over ranks of the shards' reward sums."""

    agent: PearlAgent
    env: object
    mesh: Mesh
    num_envs_per_device: int = 128
    steps_per_learn: int = 8
    axis: str = "data"

    def __post_init__(self):
        self._axis = self.mesh.axis(self.axis)
        self.device = self._axis.device
        self.agent = with_pmean_axis(self.agent.for_env(self.env), self._axis)
        self.venv = VectorEnv(self.env, self.num_envs_per_device, self.device)
        self.n_devices = self._axis.size
        self.generator = None

    def init(self, seed: int):
        """(agent_state, env_states) of this rank: the learner from the
        shared `seed`, the env shard and the rank's generator from
        `rank_seed(seed, rank)`."""
        self.generator = make_generator(rank_seed(seed, self._axis.rank), self.device)
        env_states, obs = self.venv.reset(self.generator)
        astate = self.agent.init(
            seed, self.venv.observation_dim, self.num_envs_per_device, obs, device=self.device
        )
        return astate, env_states

    def step(self, astate, env_states):
        """(agent_state, env_states, mean over ranks of the reward sums)."""
        reward = torch.zeros((), device=self.device)
        gen = self.generator
        for _ in range(self.steps_per_learn):
            astate, choice = self.agent.act(astate, gen)
            env_states, result, next_obs = self.venv.step(env_states, choice.action, gen)
            astate = self.agent.observe(astate, result, next_obs, gen)
            reward = reward + result.reward.sum()
        astate, _ = self.agent.learn(astate, gen)
        (total,) = psum([reward], self._axis)
        return astate, env_states, total / self.n_devices

    @property
    def env_steps_per_call(self) -> int:
        return self.steps_per_learn * self.num_envs_per_device * self.n_devices
