"""Actor-learner runner for throughput measurement (port of
`pearl_tpu/training/throughput.py`).

The reference fuses `learns_per_call` x (steps_per_learn env steps + one
learn) into one jitted program. Here the same loop runs eagerly on the
device; it returns only device-side scalar sums, so a call makes no host
sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device


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
        is a `torch.Generator` on the device.
    """
    device = resolve_device(device)
    if deferred_push:
        raise NotImplementedError(
            "deferred (chunk-granular) pushes are not ported yet (ROADMAP Queue A, item 9)"
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
        for _ in range(learns_per_call):
            for _ in range(steps_per_learn):
                agent_state, choice = agent.act(agent_state, generator)
                env_states, result, next_obs = venv.step(env_states, choice.action, generator)
                agent_state = agent.observe(agent_state, result, next_obs, generator)
                reward_sum += result.reward.sum()
                episodes += result.done.sum()
            if learn:
                agent_state, _ = agent.learn(agent_state, generator)
        return agent_state, env_states, {"reward_sum": reward_sum, "episodes": episodes}

    return init_fn, run_fn
