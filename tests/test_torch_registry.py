"""The port's benchmark registry (`benchmarks/configs.py`) and runner
(`benchmarks/run.py`) on the CPU.

- `METHODS` has the JAX package's rows under the same names, and each row
  builds the same composition: the learner, its networks, exploration,
  summarizer and safety module, class by class and field by field where
  both packages name the field, the replay buffer and its capacity, and the
  row's schedule (`learn_every_k_steps`, `learning_starts`, `continuous`,
  `on_policy_rollout`, `env_family`).
- Every row trains a few steps on its env family and round-trips through
  `save`/`restore`, as `tests/test_all_methods_matrix.py:52-92` holds the
  reference's rows; here the restored generators also draw what the saved
  ones draw.
- The presets and `run_benchmark` hold the properties of
  `tests/test_all_methods_matrix.py:94-158` and `tests/test_benchmark_runner.py`.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from pearl_tpu.benchmarks import configs as jax_configs
from pearl_tpu_torch.benchmarks import configs
from pearl_tpu_torch.benchmarks.configs import METHODS
from pearl_tpu_torch.benchmarks.guarantees import env_for_method
from pearl_tpu_torch.benchmarks.run import run_benchmark
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils import tree_allclose
from pearl_tpu_torch.utils.checkpoint import restore, save
from pearl_tpu_torch.utils.pytree import named_leaves, walk_leaves

torch.set_num_threads(1)

CPU = "cpu"
_PRIMITIVE = (bool, int, float, str, type(None))


def _assert_same(jax_obj, port_obj, path):
    """The same class name, and the same value of every dataclass field both
    objects have (recursing into networks, exploration, summarizers, safety
    modules); returns the number of fields compared."""
    if isinstance(jax_obj, _PRIMITIVE) or isinstance(port_obj, _PRIMITIVE):
        if isinstance(jax_obj, float) or isinstance(port_obj, float):
            assert math.isclose(jax_obj, port_obj, rel_tol=1e-12), (path, jax_obj, port_obj)
        else:
            assert jax_obj == port_obj, (path, jax_obj, port_obj)
        return 1
    if isinstance(jax_obj, (tuple, list)):
        assert len(jax_obj) == len(port_obj), (path, jax_obj, port_obj)
        return sum(_assert_same(a, b, f"{path}[{i}]") for i, (a, b) in
                   enumerate(zip(jax_obj, port_obj)))
    assert dataclasses.is_dataclass(jax_obj) and dataclasses.is_dataclass(port_obj), (
        path, jax_obj, port_obj)
    assert type(jax_obj).__name__ == type(port_obj).__name__, (path, jax_obj, port_obj)
    port_fields = {f.name for f in dataclasses.fields(port_obj)}
    n = 1
    for f in dataclasses.fields(jax_obj):
        if f.name in port_fields:
            n += _assert_same(getattr(jax_obj, f.name), getattr(port_obj, f.name),
                              f"{path}.{f.name}")
    return n


def _composition(agent):
    """What a row decides: the learner (with its networks, exploration,
    summarizer, rounds, batch size, rates), the replay buffer (class,
    capacity, stack, envs, ensemble), the safety module and the agent's
    flags."""
    return (agent.policy_learner, agent.replay_buffer, agent.safety_module,
            agent.track_available_masks, agent.store_cost)


def test_methods_have_the_reference_rows():
    assert sorted(METHODS) == sorted(jax_configs.METHODS)
    assert len(METHODS) == 39


@pytest.mark.parametrize("name", sorted(jax_configs.METHODS))
def test_method_composition_matches_the_reference(name):
    jax_method, method = jax_configs.METHODS[name], METHODS[name]
    for field in ("name", "learn_every_k_steps", "learning_starts", "continuous",
                  "on_policy_rollout", "env_family"):
        assert getattr(method, field) == getattr(jax_method, field), (name, field)
    for num_envs in (4, 16):
        jax_agent, agent = jax_method.make_agent(num_envs), method.make_agent(num_envs)
        compared = _assert_same(_composition(jax_agent), _composition(agent), name)
        assert compared >= 15, (name, compared)


def train_briefly(method, num_envs=4, device=CPU):
    """A few learns of a row on its env family (on-policy rollouts cut to
    16 steps), as the reference's breadth test runs it."""
    agent = method.make_agent(num_envs)
    env = env_for_method(method, agent)
    rollout = method.on_policy_rollout
    if rollout is not None:
        rollout = 16
        agent = dataclasses.replace(
            agent, replay_buffer=OnPolicyReplayBuffer(capacity=rollout * num_envs,
                                                      num_envs=num_envs))
    learn_every = rollout if rollout is not None else 8
    return online_learning(
        agent, env, num_envs=num_envs, max_steps=learn_every * num_envs * 3,
        learn_every_k_steps=learn_every, learning_starts=0 if rollout is not None else 32,
        seed=0, device=device,
    )


def check_trains_and_roundtrips(name, method, directory):
    """A short training of the row stays finite, and its state round-trips
    through `save`/`restore`, the generators' streams included."""
    state = train_briefly(method).agent_state
    assert state.learner.step > 0, name
    for leaf_name, leaf in named_leaves(state.learner):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            assert torch.isfinite(leaf).all(), (name, leaf_name)
    path = os.path.join(str(directory), "ckpt")
    save(path, state)
    restored = restore(path, state)
    assert tree_allclose(restored, state), name
    pairs = [(a, b) for (_, a), (_, b) in zip(walk_leaves(state), walk_leaves(restored))
             if isinstance(a, torch.Generator)]
    for a, b in pairs:
        assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b)), name


@pytest.mark.parametrize("name", sorted(jax_configs.METHODS))
def test_method_trains_and_roundtrips(name, tmp_path):
    check_trains_and_roundtrips(name, METHODS[name], tmp_path)


def test_dynamic_action_experiment_preset():
    """Each method trains on the masked Acrobot with the availability masks
    stored in replay."""
    exp = configs.dynamic_action_experiments()
    assert sorted(exp["methods"]) == ["DQN", "DoubleDQN", "SARSA"]
    env = exp["envs"]["DynamicAcrobot"]()
    for name, method in exp["methods"].items():
        agent = method.make_agent(4)
        assert agent.track_available_masks, name
        res = online_learning(agent, env, num_envs=4, max_steps=96, learn_every_k_steps=8,
                              learning_starts=32, seed=0, device=CPU)
        state = res.agent_state
        assert state.learner.step > 0, name
        n = int(state.replay.size)
        if n > 0:  # SARSA's on-policy buffer is empty right after a learn
            masks = state.replay.storage.curr_available_mask[:n]
            assert masks.all(dim=1).float().mean() < 1.0, name


def test_rc_constrained_experiment_preset():
    """All nine cells (3 methods x 3 constraint values): the constraint is
    in the safety module, each cell trains, lambda stays finite and the cost
    critic's optimizer steps."""
    exp = configs.rc_constrained_experiments()
    assert len(exp["methods"]) == 9
    env = exp["envs"]["PendulumCost"]()
    for name, method in exp["methods"].items():
        agent = method.make_agent(4)
        assert agent.safety_module.constraint_value == float(name.split("-c")[1]), name
        res = online_learning(agent, env, num_envs=4, max_steps=96, learn_every_k_steps=8,
                              learning_starts=32, seed=0, device=CPU)
        state = res.agent_state
        assert state.learner.step > 0, name
        assert math.isfinite(float(state.safety.lagrangian)), name
        steps = [v for n, v in named_leaves(state.safety) if n.endswith(".step")]
        assert steps and all(float(s) > 0 for s in steps), name


def test_experiment_presets_have_the_reference_grids():
    """Every preset names the reference's methods, env names and budgets;
    the visual preset's methods are visual rows."""
    for preset in ("classic_control_experiments", "continuous_control_experiments",
                   "ple_experiments", "dynamic_action_experiments",
                   "rc_constrained_experiments", "visual_experiments",
                   "cb_benchmark_experiments"):
        mine, ref = getattr(configs, preset)(), getattr(jax_configs, preset)()
        assert sorted(mine) == sorted(ref), preset
        assert sorted(mine["envs"]) == sorted(ref["envs"]), preset
        assert sorted(mine["methods"]) == sorted(ref["methods"]), preset
        for key in ("max_steps", "num_runs", "record_period", "steps"):
            assert mine.get(key) == ref.get(key), (preset, key)
    for name in configs.visual_experiments()["methods"]:
        assert METHODS[name].env_family == "visual", name


def test_ple_preset_envs_step():
    """The PLE grid's eight envs, the PuckWorld variants' wrappers among
    them, reset and step at 4 envs."""
    from pearl_tpu_torch.envs import VectorEnv

    for name, make in configs.ple_experiments()["envs"].items():
        venv = VectorEnv(make(), 4, torch.device(CPU))
        gen = torch.Generator().manual_seed(0)
        states, obs = venv.reset(gen)
        actions = torch.zeros((4, 1))
        _, result, next_obs = venv.step(states, actions, gen)
        assert next_obs.shape == obs.shape and torch.isfinite(result.reward).all(), name


def test_run_benchmark_shapes_npy_and_plot(tmp_path):
    """tests/test_benchmark_runner.py at its settings: (runs, bins) curves
    per method, saved as .npy, and the mean +/- stderr figure."""
    out = str(tmp_path / "grid")
    results = run_benchmark(["DQN", "SAC"], CartPole, num_envs=4, max_steps=2_000,
                            record_period=500, num_runs=2, out_dir=out, plot=True, device=CPU)
    assert set(results) == {"DQN", "SAC"}
    for name, curves in results.items():
        assert curves.shape == (2, 4), (name, curves.shape)
        assert np.isfinite(curves[~np.isnan(curves)]).all()
        saved = np.load(os.path.join(out, f"{name}.npy"))
        np.testing.assert_array_equal(saved, curves)
    assert os.path.getsize(os.path.join(out, "benchmark.png")) > 1_000
