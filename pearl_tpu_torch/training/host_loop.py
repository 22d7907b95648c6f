"""Host-side step-at-a-time training loops (port of
`pearl_tpu/training/host_loop.py`).

One env instance, one step per Python iteration, as the reference Pearl's
own `run_episode`/`online_learning` loop. Only for:

- parity checks against real Gymnasium dynamics (`envs/gym_adapter.py`) and
  host emulators such as the Atari stack (`envs/atari.py`);
- host-only learners (`DictTabularQLearning`).

The vectorized drivers (`training/online.py`) are the production path; these
loops pay a host round trip per step by design.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device


def _is_host_env(env) -> bool:
    return hasattr(env, "_gym")


def run_episode_host(
    env,
    learner,
    *,
    learn: bool = True,
    exploit: bool = False,
    max_steps: int = 10_000,
    seed: Optional[int] = None,
) -> float:
    """One episode of a host learner with `DictTabularQLearning`'s act/learn
    API on a host env (`GymEnvironment`). Returns the episode return.

    A device env cannot run here: the reference calls `env.reset(None)` and
    `env.step(None, ...)` on one, which neither package's device envs take;
    this port raises a TypeError instead."""
    if not _is_host_env(env):
        raise TypeError(
            f"run_episode_host steps a host env (GymEnvironment), not a "
            f"{type(env).__name__}: drive a device env with online_learning or "
            "agent_online_learning_host"
        )
    num_actions = env.action_space.n
    _, obs = env.reset(seed=seed)
    obs = np.asarray(obs)
    total = 0.0
    for _ in range(max_steps):
        action = learner.act(obs, num_actions, exploit=exploit)
        _, result = env.step(None, np.asarray([float(action)]))
        next_obs = np.asarray(result.observation)
        reward = float(result.reward)
        terminated = bool(result.terminated)
        if learn:
            learner.learn(obs, action, reward, next_obs, terminated, num_actions)
        total += reward
        obs = next_obs
        if terminated or bool(result.truncated):
            break
    return total


def online_learning_host(
    env,
    learner,
    *,
    number_of_episodes: int = 100,
    learn: bool = True,
    seed: int = 0,
) -> List[float]:
    """`number_of_episodes` episodes, episode e reset with seed `seed + e`;
    returns the per-episode returns."""
    return [
        run_episode_host(env, learner, learn=learn, seed=seed + ep)
        for ep in range(number_of_episodes)
    ]


def agent_online_learning_host(
    agent,
    env,
    *,
    max_steps: int = 100_000,
    learn_every_k_steps: int = 4,
    learning_starts: int = 0,
    seed: int = 0,
    exploit: bool = False,
    learn: bool = True,
    verbose: bool = False,
    device: DeviceLike = None,
) -> List[float]:
    """A `PearlAgent` on `device` (the card unless `device="cpu"`) driving
    one env with a batch axis of 1: the Atari topology, emulator on the
    host, act/observe/learn on the device. Returns the per-episode returns
    in finish order.

    One host read per step: on a host env (`GymEnvironment`) the action,
    which the emulator needs; on a device env (a batch of one) the step's
    reward and done flag, which the loop needs to end the episode. When an
    episode ends the env is reset, and the agent's window is seeded with the
    post-reset observation (the reference seeds it with the terminal one and
    acts on that at the next episode's first step)."""
    device = resolve_device(device)
    agent = agent.for_env(env)
    host = _is_host_env(env)
    generator = make_generator(seed, device)

    def reset(episode):
        """(env state, the (1, d) observation on `device`)."""
        if host:
            state, obs = env.reset(seed=seed + episode)
            return state, obs.to(device).reshape(1, -1)
        return env.reset(1, generator, device)

    env_state, obs = reset(0)
    astate = agent.init(seed, obs.shape[1], 1, obs, device=device)

    returns: List[float] = []
    ep_ret = 0.0
    for step in range(max_steps):
        astate, choice = agent.act(astate, generator, exploit=exploit)
        if host:
            env_state, result = env.step(env_state, choice.action[0].cpu().numpy())
            reward, done = float(result.reward), bool(result.done)
            result = _batched(result, device)
        else:
            env_state, result = env.step(env_state, choice.action)
            reward, done = torch.stack(
                [result.reward, result.done.to(torch.float32)], dim=1
            )[0].tolist()
        next_obs = result.observation.reshape(1, -1)
        ep_ret += reward
        if done:
            returns.append(ep_ret)
            if verbose:
                print(f"step={step} episode={len(returns)} return={ep_ret:.1f}")
            ep_ret = 0.0
            env_state, next_obs = reset(len(returns))
        astate = agent.observe(astate, result, next_obs, generator)
        if learn and step >= learning_starts and (step + 1) % learn_every_k_steps == 0:
            astate, _ = agent.learn(astate, generator)
    return returns


def _batched(result, device):
    """A host env's `ActionResult` as a batch of one on `device`."""

    def lift(x):
        return None if x is None else torch.as_tensor(x).to(device).reshape(1, *x.shape)

    return dataclasses.replace(
        result,
        observation=lift(result.observation),
        reward=lift(result.reward),
        terminated=lift(result.terminated),
        truncated=lift(result.truncated),
        cost=lift(result.cost),
        available_actions_mask=lift(result.available_actions_mask),
    )
