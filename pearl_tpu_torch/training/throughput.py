"""Actor-learner runner for throughput measurement (port of
`pearl_tpu/training/throughput.py`).

The reference fuses `learns_per_call` x (steps_per_learn env steps + one
learn) into one jitted program. Here the same loop runs eagerly on the
device; it returns only device-side scalar sums, so a call makes no host
sync.

`deferred_push=True` collects each chunk's transitions and writes them in one
step-major push of steps_per_learn * num_envs rows: one ring write per chunk
instead of one per step, the same rows whenever capacity %
(steps_per_learn * num_envs) == 0. It needs
`replay_buffer.supports_deferred_push`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import tree_map


def make_compiled_runner(
    agent: PearlAgent,
    env,
    *,
    num_envs: int,
    steps_per_learn: int = 8,
    learns_per_call: int = 16,
    learn: bool = True,
    deferred_push: Optional[bool] = None,
    device: DeviceLike = None,
):
    """Returns (init_fn, run_fn), on `device` (the card unless `device="cpu"`).

    init_fn(seed) -> (agent_state, env_states)
    run_fn(agent_state, env_states, generator)
        -> (agent_state, env_states, {"reward_sum", "episodes"}); executes
        steps_per_learn * learns_per_call * num_envs env steps. `generator`
        is a `torch.Generator` on the device. An env that reports
        `info["regret"]` (the contextual bandits) adds "regret_sum".
    """
    device = resolve_device(device)
    deferred_push = bool(deferred_push)
    if deferred_push and not agent.replay_buffer.supports_deferred_push:
        raise ValueError(
            f"{type(agent.replay_buffer).__name__} does not support deferred "
            "(chunk-granular) pushes"
        )
    agent = agent.for_env(env)
    venv = VectorEnv(env, num_envs, device)

    def init_fn(seed: int):
        env_states, obs = venv.reset(make_generator(seed, device))
        agent_state = agent.init(seed, venv.observation_dim, num_envs, obs, device=device)
        return agent_state, env_states

    def run_fn(agent_state, env_states, generator: torch.Generator):
        reward_sum = torch.zeros((), device=device)
        episodes = torch.zeros((), dtype=torch.int64, device=device)
        regret_sum = None
        for _ in range(learns_per_call):
            transitions = []
            for _ in range(steps_per_learn):
                agent_state, choice = agent.act(agent_state, generator)
                env_states, result, next_obs = venv.step(env_states, choice.action, generator)
                if deferred_push:
                    agent_state, transition = agent.observe_deferred(
                        agent_state, result, next_obs, generator
                    )
                    transitions.append(transition)
                else:
                    agent_state = agent.observe(agent_state, result, next_obs, generator)
                reward_sum += result.reward.sum()
                episodes += result.done.sum()
                if "regret" in result.info:
                    regret = result.info["regret"].sum()
                    regret_sum = regret if regret_sum is None else regret_sum + regret
            if deferred_push:
                flat = tree_map(lambda *xs: torch.cat(xs), *transitions)
                replay = agent.replay_buffer.push(agent_state.replay, flat, generator)
                agent_state = dataclasses.replace(agent_state, replay=replay)
            if learn:
                agent_state, _ = agent.learn(agent_state, generator)
        stats = {"reward_sum": reward_sum, "episodes": episodes}
        if regret_sum is not None:
            stats["regret_sum"] = regret_sum
        return agent_state, env_states, stats

    return init_fn, run_fn
