"""Atari preprocessing wrappers (port of `pearl_tpu/envs/atari.py`).

Host-side gymnasium wrappers, numpy code with the reference's behaviour:
Atari emulation runs on the host, so the stack sits in front of
`GymEnvironment` and trains through `training/host_loop.py`. Lives are read
from `info["lives"]`, or from `env.unwrapped.ale.lives()` when an ALE is
present, so the stack runs on a scripted fake without a ROM. This module
needs gymnasium; the rest of the package does not.
"""

from __future__ import annotations

from typing import Optional

import gymnasium  # the wrappers subclass gymnasium.Wrapper
import numpy as np


def _lives(env, info) -> int:
    if isinstance(info, dict) and "lives" in info:
        return int(info["lives"])
    ale = getattr(getattr(env, "unwrapped", env), "ale", None)
    if ale is not None:
        return int(ale.lives())
    return 0


class NoopResetEnv(gymnasium.Wrapper):
    """Start each episode with a random number (1..noop_max) of no-op steps,
    decorrelating initial states."""

    def __init__(self, env, noop_max: int = 30, noop_action: int = 0):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = noop_action

    def reset(self, *, seed: Optional[int] = None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        n = int(self.np_random.integers(1, self.noop_max + 1))
        for _ in range(n):
            obs, _, terminated, truncated, info = self.env.step(self.noop_action)
            if terminated or truncated:
                obs, info = self.env.reset(seed=seed, options=options)
        return obs, info


class FireResetEnv(gymnasium.Wrapper):
    """Press FIRE after reset, for games that stall until it is pressed."""

    def __init__(self, env, fire_action: int = 1):
        super().__init__(env)
        self.fire_action = fire_action

    def reset(self, *, seed: Optional[int] = None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        obs, _, terminated, truncated, info = self.env.step(self.fire_action)
        if terminated or truncated:
            obs, info = self.env.reset(seed=seed, options=options)
        return obs, info


class EpisodicLifeEnv(gymnasium.Wrapper):
    """Report a life lost as the end of an episode, and reset the emulator
    only when the game is over."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = bool(terminated or truncated)
        lives = _lives(self.env, info)
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options=None):
        if self.was_real_done:
            obs, info = self.env.reset(seed=seed, options=options)
        else:
            # Continue the game from the state where the life was lost.
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(seed=seed, options=options)
        self.lives = _lives(self.env, info)
        return obs, info


class MaxAndSkipEnv(gymnasium.Wrapper):
    """Repeat each action `skip` frames; return the sum of the rewards and
    the pixel-wise max of the last two frames (flicker removal)."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self.skip = skip
        self._frames = None  # (2,) + obs shape, allocated at the first step

    def step(self, action):
        total = 0.0
        terminated = truncated = False
        info = {}
        for i in range(self.skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            obs = np.asarray(obs)
            if self._frames is None:
                self._frames = np.zeros((2,) + obs.shape, obs.dtype)
            if i >= self.skip - 2:
                self._frames[i - (self.skip - 2)] = obs
            total += float(reward)
            if terminated or truncated:
                break
        return self._frames.max(axis=0), total, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options=None):
        self._frames = None
        return self.env.reset(seed=seed, options=options)


def wrap_atari(
    env,
    *,
    noop_max: int = 30,
    skip: int = 4,
    episodic_life: bool = True,
    fire_reset: bool = True,
):
    """The reference Pearl's Atari stack, in its order: NoopReset,
    MaxAndSkip, EpisodicLife, then FireReset when the game has FIRE."""
    env = NoopResetEnv(env, noop_max=noop_max)
    if skip > 1:
        env = MaxAndSkipEnv(env, skip=skip)
    if episodic_life:
        env = EpisodicLifeEnv(env)
    if fire_reset:
        get_meanings = getattr(env.unwrapped, "get_action_meanings", None)
        meanings = list(get_meanings()) if callable(get_meanings) else []
        if "FIRE" in meanings:
            env = FireResetEnv(env, fire_action=meanings.index("FIRE"))
    return env
