"""The two ranks of the port's distribution tests (tests/test_torch_parallel.py
and tests/test_torch_parallel_online.py). Imports torch and the port, never
JAX.

`start(group, directory)` starts two processes with `torch.multiprocessing`
(the spawn method), joined as a gloo world through a file in `directory` (no
TCP port to race for between test workers); they import what they need while
the parent prepares their inputs, and wait for `send(group, directory,
inputs)`. `finish` waits for them and returns each rank's results. Each rank
runs every scenario of the group in the same order, at a tiny size, and saves
{scenario: result}.
A scenario that should raise records the error's message; any other error
fails the rank, and the parent's `finish` raises it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def start(group: str, directory):
    return mp.start_processes(
        _main, args=(group, str(directory)), nprocs=WORLD, join=False, start_method="spawn"
    )


def send(group: str, directory, inputs=None) -> None:
    """The ranks' inputs, written whole before the ranks can see the file."""
    path = Path(directory) / f"{group}_inputs.pt"
    torch.save(inputs, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


def stop(context) -> None:
    """End the ranks (the parent failed before they could finish)."""
    for p in context.processes:
        if p.is_alive():
            p.kill()
        p.join()


def finish(context, group: str, directory, timeout_s: float = 240.0) -> list:
    deadline = time.monotonic() + timeout_s
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            stop(context)
            raise TimeoutError(f"the ranks of {group!r} did not finish in {timeout_s} s")
    return [torch.load(Path(directory) / f"{group}_rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _main(rank: int, group: str, directory: str):
    import pearl_tpu_torch.training  # noqa: F401 - imported while the parent prepares
    from pearl_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    directory = Path(directory)
    multihost.initialize(f"file://{directory / (group + '_rendezvous')}", WORLD, rank,
                         backend="gloo")
    inputs_path = directory / f"{group}_inputs.pt"
    deadline = time.monotonic() + 300.0
    while not inputs_path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs for {group!r} in 300 s")
        time.sleep(0.05)
    inputs = torch.load(inputs_path, weights_only=False)
    results = {}
    for name, scenario in GROUPS[group].items():
        results[name] = scenario(rank, inputs, directory)
    torch.save(results, directory / f"{group}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def raised(fn) -> str:
    """The message of the error `fn()` raises ("" if it returns)."""
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as err:
        return f"{type(err).__name__}: {err}"
    return ""


def digest(tree) -> dict:
    """{name: tensor} of every tensor leaf (generators as their states)."""
    from pearl_tpu_torch.utils.pytree import named_leaves

    return {n: v.detach().cpu().clone() for n, v in named_leaves(tree)
            if isinstance(v, torch.Tensor)}


def replicated(astate) -> dict:
    """The leaves that must be equal on every rank: the learner's but its
    per-env exploration state, and the safety module's."""
    learner = astate.learner
    if hasattr(learner, "explore_state"):
        learner = dataclasses.replace(learner, explore_state=None)
    return digest({"learner": learner, "safety": astate.safety})


@contextlib.contextmanager
def recording_folds():
    """Record every statistics fold of `online_learning(mesh=...)` as
    (this rank's unfolded tensor, the folded one), in dispatch order."""
    from pearl_tpu_torch.training import online

    folds, fold = [], online._fold_stats

    def recorded(stats_dev, stats, axis):
        out = fold(stats_dev, stats, axis)
        folds.append((stats_dev.cpu().clone(), out.cpu().clone()))
        return out

    online._fold_stats = recorded
    try:
        yield folds
    finally:
        online._fold_stats = fold


# ---------------------------------------------------------------- learn steps
def learn_steps(rank, inputs, directory):
    """Each case: `method` of the case's learner (or module), with this
    rank's `pmean_axis`, called on the threaded state with this rank's
    arguments, step after step."""
    from pearl_tpu_torch.parallel import make_mesh

    axis = make_mesh(WORLD, device="cpu").axis("data")
    out = {}
    for name, case in inputs["learn"].items():
        obj = dataclasses.replace(case["obj"], pmean_axis=axis)
        state, metrics = case["state"], []
        for step in case["steps"]:
            args, kwargs = step[rank]
            result = getattr(obj, case["method"])(state, *args, **kwargs)
            state = result[0]
            metrics.append({k: v.detach().clone() for k, v in result[-1].items()})
        out[name] = {"state": state, "metrics": metrics}
    return out


def ensemble(rank, inputs, directory):
    """The sharded learn on (1, 2) and (2, 1) meshes from the same full
    state and batches, and the indivisible ensemble."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.parallel import (
        make_2d_mesh,
        make_ensemble_sharded_learn_batch,
        split_ensemble_state,
    )
    from pearl_tpu_torch.utils.pytree import tree_map

    case = inputs["ensemble"]
    learner = case["learner"]
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_2d_mesh(*shape, device="cpu")
        d, m = mesh.axis("data").rank, mesh.axis("model").rank
        learn = make_ensemble_sharded_learn_batch(PearlAgent(policy_learner=learner), mesh)
        state = split_ensemble_state(learner, case["state"], shape[1])[m]
        metrics = []
        for batch in case["batches"]:
            n = batch.reward.shape[0] // shape[0]
            state, mt = learn(state, tree_map(lambda x: x[d * n:(d + 1) * n], batch))
            metrics.append(mt)
        out[shape] = {"state": state, "data_rank": d, "model_rank": m, "metrics": metrics}
    mesh = make_2d_mesh(1, 2, device="cpu")
    out["indivisible"] = raised(lambda: make_ensemble_sharded_learn_batch(
        PearlAgent(policy_learner=case["indivisible"]), mesh))
    return out


# ------------------------------------------------------------- online driver
def _dqn_agent(capacity=512, batch_size=32, learner_cls=None):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    cls = learner_cls or DeepQLearning
    return PearlAgent(
        policy_learner=cls(training_rounds=1, batch_size=batch_size),
        replay_buffer=BasicReplayBuffer(capacity=capacity),
    )


def _mesh2():
    from pearl_tpu_torch.parallel import make_mesh

    return make_mesh(WORLD, device="cpu")


def mesh_summary_early_stop(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    with recording_folds() as folds:
        res = online_learning(
            _dqn_agent(), CartPole(), num_envs=8, max_steps=300_000, learn_every_k_steps=4,
            chunks_per_dispatch=2, seed=0, stats="summary", target_return=12.0,
            target_window=4, mesh=_mesh2(),
        )
    return {"reached": res.reached_target, "total_steps": res.total_steps,
            "total_episodes": res.total_episodes, "curve": res.return_curve, "folds": folds,
            "learner": replicated(res.agent_state),
            "replay": res.agent_state.replay.storage.state.clone()}


def mesh_num_envs_must_divide(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    return raised(lambda: online_learning(_dqn_agent(), CartPole(), num_envs=7, mesh=_mesh2()))


def mesh_curves(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    kw = dict(num_envs=8, max_steps=2048, learn_every_k_steps=4, chunks_per_dispatch=2, seed=1,
              mesh=_mesh2())
    with recording_folds() as folds:
        res = online_learning(_dqn_agent(), CartPole(), stats="curves", curve_capacity=1024, **kw)
    with recording_folds() as full_folds:
        full = online_learning(_dqn_agent(), CartPole(), stats="full", **kw)
    return {"dropped": res.episodes_dropped, "returns": res.episode_returns,
            "total_episodes": res.total_episodes, "learner": replicated(res.agent_state),
            "full_returns": full.episode_returns, "folds": folds, "full_folds": full_folds}


def mesh_ppo_learn_then_clear(rank, inputs, directory):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ProximalPolicyOptimization,
    )
    from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer
    from pearl_tpu_torch.training import online_learning

    envs_per_dev, rollout = 2, 8
    agent = PearlAgent(
        policy_learner=ProximalPolicyOptimization(training_rounds=1, batch_size=16),
        replay_buffer=OnPolicyReplayBuffer(capacity=rollout * envs_per_dev,
                                           num_envs=envs_per_dev),
    )
    res = online_learning(agent, CartPole(), num_envs=4, max_steps=4 * rollout * 4,
                          learn_every_k_steps=rollout, seed=0, stats="summary", mesh=_mesh2())
    return {"replay_size": int(res.agent_state.replay.size), "steps": res.agent_state.learner.step,
            "learner": replicated(res.agent_state)}


def mesh_lstm_summarizer_carry(rank, inputs, directory):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.history_summarization_modules import LSTMHistorySummarization
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=1, batch_size=16,
            history_summarizer=LSTMHistorySummarization(history_length=4, hidden_dim=16),
        ),
        replay_buffer=BasicReplayBuffer(capacity=256),
    )
    res = online_learning(agent, CartPole(), num_envs=4, max_steps=512, learn_every_k_steps=4,
                          seed=0, stats="summary", mesh=_mesh2())
    return {"carry": digest(res.agent_state.history_carry),
            "summarizer_moves": res.agent_state.learner.step,
            "learner": replicated(res.agent_state)}


def mesh_csac_rc_lambda_sync(rank, inputs, directory):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import Pendulum
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ContinuousSoftActorCritic,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.safety_modules import RCSafetyModuleCostCriticContinuousAction
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=ContinuousSoftActorCritic(training_rounds=1, batch_size=16),
        replay_buffer=BasicReplayBuffer(capacity=256),
        safety_module=RCSafetyModuleCostCriticContinuousAction(constraint_value=0.05,
                                                               batch_size=16),
        store_cost=True,
    )
    res = online_learning(agent, Pendulum(emit_torque_cost=True), num_envs=4, max_steps=256,
                          learn_every_k_steps=8, learning_starts=64, seed=0, stats="summary",
                          mesh=_mesh2())
    return {"lambda": res.agent_state.safety.lagrangian.clone(),
            "log_alpha": res.agent_state.learner.extra.log_alpha.detach().clone(),
            "learner": replicated(res.agent_state)}


def _exchange(state, directory, name, rank):
    """Every rank's state of a run, in rank order, through files."""
    from pearl_tpu_torch.utils.checkpoint import restore, save

    save(str(directory / f"{name}_rank{rank}.pt"), state)
    dist.barrier()
    return [restore(str(directory / f"{name}_rank{r}.pt"), state) for r in range(WORLD)]


def mesh_restore_and_reshard(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import make_mesh, reshard_agent_state
    from pearl_tpu_torch.training import online_learning

    agent, mesh2 = _dqn_agent(), _mesh2()
    kw = dict(learn_every_k_steps=4, stats="summary")
    res = online_learning(agent, CartPole(), num_envs=8, max_steps=1024, seed=0, mesh=mesh2, **kw)
    # Resume on the same mesh, each rank from its own state.
    res2 = online_learning(agent, CartPole(), num_envs=8, max_steps=512, seed=1, mesh=mesh2,
                           agent_state=res.agent_state, **kw)
    out = {"resumed": replicated(res2.agent_state), "resumed_step": res2.agent_state.learner.step}
    # 2 -> 1: rank 0 goes on alone from the mesh's states.
    states = _exchange(res.agent_state, directory, "reshard", rank)
    solo = reshard_agent_state(states, 1)
    mesh1 = make_mesh(1, device="cpu")  # every rank makes the group; rank 0 is in it
    if mesh1.member:
        res3 = online_learning(agent, CartPole(), num_envs=4, max_steps=512, seed=2, mesh=mesh1,
                               agent_state=solo, **kw)
        out["narrow_steps"] = res3.total_steps
    out["member"] = mesh1.member
    # 1 -> 2: cyclic reuse gives a full list of independent copies.
    wide = reshard_agent_state(solo, 2)
    out["wide"] = (len(wide), wide[0] is not wide[1],
                   next(wide[0].learner.params.parameters()).data_ptr()
                   != next(wide[1].learner.params.parameters()).data_ptr())
    return out


def mesh_wrong_stack_width_raises(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import reshard_agent_state
    from pearl_tpu_torch.training import online_learning

    agent, mesh2 = _dqn_agent(), _mesh2()
    kw = dict(num_envs=4, max_steps=256, learn_every_k_steps=4, seed=0, stats="summary",
              mesh=mesh2)
    res = online_learning(agent, CartPole(), **kw)
    solo = reshard_agent_state([res.agent_state], 1)
    return raised(lambda: online_learning(agent, CartPole(), agent_state=solo, **kw))


def _no_sync_dqn():
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning

    @dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
    class NoSyncDQN(DeepQLearning):
        """Applies LOCAL gradients (no pmean): the replicas diverge at the
        first learn, each from its own replay shard."""

        def learn_batch(self, state, batch):
            return DeepQLearning.learn_batch(dataclasses.replace(self, pmean_axis=None),
                                             state, batch)

    return NoSyncDQN


def check_replication_catches_missing_pmean(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    broken = _dqn_agent(capacity=512, batch_size=32, learner_cls=_no_sync_dqn())
    return raised(lambda: online_learning(
        broken, CartPole(), num_envs=8, max_steps=8192, learn_every_k_steps=4, seed=0,
        stats="summary", mesh=_mesh2(), check_replication=True,
    ))


def check_replication_passes_for_synced_learner(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    res = online_learning(_dqn_agent(), CartPole(), num_envs=8, max_steps=1024,
                          learn_every_k_steps=4, seed=0, stats="summary", mesh=_mesh2(),
                          check_replication=True)
    return {"total_steps": res.total_steps, "learner": replicated(res.agent_state)}


def dp_runner_replicas_stay_in_sync(rank, inputs, directory):
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import DataParallelRunner

    runner = DataParallelRunner(_dqn_agent(capacity=256, batch_size=16), CartPole(), _mesh2(),
                                num_envs_per_device=4, steps_per_learn=4)
    astate, env_states = runner.init(0)
    rewards = []
    for _ in range(2):
        astate, env_states, reward = runner.step(astate, env_states)
        rewards.append(float(reward))
    return {"learner": replicated(astate), "step": astate.learner.step,
            "env": digest(env_states), "rewards": rewards, "n_devices": runner.n_devices,
            "env_steps_per_call": runner.env_steps_per_call}


def two_process_data_parallel(rank, inputs, directory):
    """tests/integration/test_multiprocess_dp.py: three DP steps over the
    job's global mesh; the learner replicas and the summed reward agree."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import DataParallelRunner, multihost

    assert multihost.process_index() == rank
    mesh = multihost.global_mesh(device="cpu")
    runner = DataParallelRunner(_dqn_agent(capacity=4096, batch_size=32), CartPole(), mesh,
                                num_envs_per_device=16, steps_per_learn=4)
    astate, env_states = runner.init(0)
    for _ in range(3):
        astate, env_states, reward = runner.step(astate, env_states)
    params_hash = sum(float(v.double().abs().sum()) for v in digest(astate.learner).values()
                      if v.is_floating_point())
    return {"params_hash": params_hash, "reward": float(reward), "size": mesh.size}


def dp_checkpoint_and_mesh_width_change(rank, inputs, directory):
    """tests/test_checkpoint_population_dp.py:64-107: each rank saves its
    state; the run resumes on one rank (2 -> 1) and back on two (1 -> 2)."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import make_mesh, reshard_agent_state
    from pearl_tpu_torch.training import online_learning
    from pearl_tpu_torch.utils.checkpoint import restore, save
    from pearl_tpu_torch.utils.pytree import compare

    agent, mesh2 = _dqn_agent(capacity=256, batch_size=16), _mesh2()
    kw = dict(learn_every_k_steps=4, stats="summary")
    res = online_learning(agent, CartPole(), num_envs=8, max_steps=1024, seed=0, mesh=mesh2, **kw)
    path = str(directory / f"dp_rank{rank}.pt")
    save(path, res.agent_state)
    roundtrip = compare(restore(path, res.agent_state), res.agent_state, rtol=0, atol=0)
    dist.barrier()
    states = [restore(str(directory / f"dp_rank{r}.pt"), res.agent_state) for r in range(WORLD)]
    narrow = reshard_agent_state(states, 1)
    mesh1 = make_mesh(1, device="cpu")
    out = {"roundtrip": roundtrip, "step_before": res.agent_state.learner.step}
    if mesh1.member:
        cont = online_learning(agent, CartPole(), num_envs=4, max_steps=256, seed=1, mesh=mesh1,
                               agent_state=narrow, **kw)
        out["narrow"] = (cont.total_steps, cont.agent_state.learner.step)
        save(str(directory / "dp_narrow.pt"), cont.agent_state)
    dist.barrier()
    cont_state = restore(str(directory / "dp_narrow.pt"), res.agent_state)
    wide = reshard_agent_state([cont_state], 2)
    cont2 = online_learning(agent, CartPole(), num_envs=8, max_steps=256, seed=2, mesh=mesh2,
                            agent_state=wide, **kw)
    out["wide"] = (cont2.total_steps, replicated(cont2.agent_state))
    return out


GROUPS = {
    "learn": {"learn_steps": learn_steps, "ensemble": ensemble},
    "online": {
        "mesh_summary_early_stop": mesh_summary_early_stop,
        "mesh_num_envs_must_divide": mesh_num_envs_must_divide,
        "mesh_curves": mesh_curves,
        "mesh_ppo_learn_then_clear": mesh_ppo_learn_then_clear,
        "mesh_lstm_summarizer_carry": mesh_lstm_summarizer_carry,
        "mesh_csac_rc_lambda_sync": mesh_csac_rc_lambda_sync,
        "mesh_restore_and_reshard": mesh_restore_and_reshard,
        "mesh_wrong_stack_width_raises": mesh_wrong_stack_width_raises,
        "check_replication_catches_missing_pmean": check_replication_catches_missing_pmean,
        "check_replication_passes_for_synced_learner": check_replication_passes_for_synced_learner,
        "dp_runner_replicas_stay_in_sync": dp_runner_replicas_stay_in_sync,
        "two_process_data_parallel": two_process_data_parallel,
        "dp_checkpoint_and_mesh_width_change": dp_checkpoint_and_mesh_width_change,
    },
}
