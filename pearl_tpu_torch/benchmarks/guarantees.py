"""What every registry row must show, as functions: the row logic of the
reference's matrix suites (`tests/test_learning_signal_matrix.py`,
`tests/test_td_discount_calibration.py`), at their thresholds. The port's
test suites run them on the CPU and `chip_smoke.py` on the card.

- `env_for_method`: the env family a row trains on, as the reference's
  breadth test pairs them (`tests/test_all_methods_matrix.py:17-47`).
- `frozen_target_signal`: the replay filled with real rollouts, the targets
  frozen (every stored transition terminated, so a TD target is the stored
  reward; a dense target where the rewards are sparse), then the learner's
  own `learn` on the same data. A learner whose loss is wired to zero, whose
  gradient does not flow or whose optimizer does not step misses one of the
  `SignalReport`'s thresholds.
- `fixed_point_q`: a TD learner on a buffer of one self-loop transition
  (s0, a0, r = 1, s0), repeated; Q(s0, a0) reaches the Bellman fixed point
  1 / (1 - gamma), which a mis-scaled discount misses (the frozen targets
  above leave gamma inert).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from pearl_tpu_torch.api.spaces import DiscreteActionSpace
from pearl_tpu_torch.replay_buffers import (
    BasicReplayBuffer,
    OnPolicyReplayBuffer,
    SARSAReplayBuffer,
    TransitionBatch,
)
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils.device import make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import tree_map

# The primary loss metric of each learner family, in lookup order.
METRIC_PRIORITY = ("loss", "critic_loss", "value_loss")
# The reference's thresholds (tests/test_learning_signal_matrix.py:25-43),
# each at least 2x its measured worst late / early ratio: 0.136 for CNNDQN,
# 0.125 for CQL, 0.055 or less for every other row.
RATIO_DEFAULT = 0.15
RATIO_OVERRIDES = {"CNNDQN": 0.30, "CQL": 0.30}
# The fitted |TD| of the TD families must end small, not only smaller.
TD_LATE_FLOOR = 0.5
EARLY_FLOOR = 1e-3


def env_for_method(method, agent):
    """The env family of a row, as the reference's breadth test pairs them."""
    from pearl_tpu_torch import envs

    if method.env_family == "visual":
        return envs.Breakout()
    if method.env_family == "visual_frames":
        return envs.SyntheticAtari(height=12, width=12, frames=1, episode_len=32)
    if agent.store_cost and method.continuous:
        return envs.Pendulum(emit_torque_cost=True)
    if agent.store_cost:
        return envs.SafetyWrapper(envs.CartPole(), risky_fn=lambda obs, action: obs[..., 0] > 0.5)
    if method.continuous:
        return envs.Pendulum()
    if agent.track_available_masks:
        return envs.DynamicActionSpaceWrapper(envs.CartPole(), interval=4, num_masked=1)
    return envs.CartPole()


@dataclasses.dataclass
class SignalReport:
    """A row's primary loss metric over its learns on frozen targets: the
    means of the first and the last three learns, and the ratio late / early
    they must stay under."""

    name: str
    metric: str
    early: float
    late: float
    threshold: float
    finite: bool
    learns: int

    @property
    def ratio(self) -> float:
        return self.late / self.early if self.early > 0 else math.inf

    def failures(self) -> List[str]:
        """What the row missed; empty when it shows a learning signal."""
        out = []
        if not self.finite:
            out.append(f"{self.metric} is not finite")
        if not self.early > EARLY_FLOOR:
            out.append(f"early {self.metric} {self.early:.3e} is not above {EARLY_FLOOR}")
        if not self.late < self.threshold * self.early:
            out.append(f"late / early {self.ratio:.4f} is not under {self.threshold}")
        if self.metric == "loss" and not self.late < TD_LATE_FLOOR:
            out.append(f"late |TD| {self.late:.4f} is not under {TD_LATE_FLOOR}")
        return out


def _freeze_targets(storage) -> None:
    """Every stored transition terminated, in place; where the mean |reward|
    is under 0.05 (sparse rewards, e.g. Breakout) the reward becomes 1 plus
    the mean of the stored state, a dense function of it."""
    rest, states = (storage["rest"], storage["frame_s"]) if isinstance(storage, dict) else (
        storage, storage.state)
    rest.terminated.fill_(True)
    if rest.reward.abs().mean().item() < 0.05:
        n = rest.reward.shape[0]
        rest.reward.copy_(1.0 + states.reshape(n, -1).to(torch.float32).mean(dim=1))


def frozen_target_signal(name: str, method, seed: int = 0, learn_seed: int = 1,
                         device=None) -> SignalReport:
    """The reference's learning-signal check of one row at 4 envs: 32 steps
    a env of rollouts (a fresh 16-step `OnPolicyReplayBuffer` for on-policy
    rows) without learning, the targets frozen, then 60 calls of the
    learner's own `learn` (90 for visual rows) with a generator seeded
    `learn_seed`. The metrics stay on the device until the last learn."""
    device = resolve_device(device)
    num_envs = 4
    agent = method.make_agent(num_envs)
    env = env_for_method(method, agent)
    rollout = method.on_policy_rollout
    if rollout is not None:
        rollout = 16
        agent = dataclasses.replace(
            agent, replay_buffer=OnPolicyReplayBuffer(capacity=rollout * num_envs,
                                                      num_envs=num_envs))
    steps = rollout or 32
    res = online_learning(agent, env, num_envs=num_envs, max_steps=steps * num_envs,
                          learn_every_k_steps=steps, learn=False, seed=seed, device=device)
    learner_state, buffer_state = res.agent_state.learner, res.agent_state.replay
    if buffer_state.size == 0:
        raise ValueError(f"{name}: the rollouts stored nothing")
    _freeze_targets(buffer_state.storage)

    learner, buffer = agent.for_env(env).policy_learner, agent.replay_buffer
    learns = 90 if method.env_family.startswith("visual") else 60
    generator = make_generator(learn_seed, device)
    history = []
    for _ in range(learns):
        learner_state, buffer_state, metrics = learner.learn(
            learner_state, buffer, buffer_state, generator)
        history.append(metrics)
    metric = next((k for k in METRIC_PRIORITY if k in history[0]), None)
    if metric is None:
        raise ValueError(f"{name}: none of {METRIC_PRIORITY} in the metrics {sorted(history[0])}")
    values = torch.stack([m[metric] for m in history]).cpu()
    return SignalReport(
        name=name, metric=metric, early=values[:3].mean().item(), late=values[-3:].mean().item(),
        threshold=RATIO_OVERRIDES.get(name, RATIO_DEFAULT),
        finite=bool(torch.isfinite(values).all()), learns=learns,
    )


def _self_loop_batch(sarsa: bool, device) -> TransitionBatch:
    """64 copies of the non-terminal transition (s0 = 0.5 * ones(4), action
    0 of 2, r = 1, s0), with action 0 as the next action for SARSA."""
    n = 64
    s0 = torch.full((n, 4), 0.5, device=device)
    action = torch.zeros((n, 2), device=device)
    action[:, 0] = 1.0
    index = torch.zeros((n,), dtype=torch.int32, device=device)
    extra = {"next_action": action.clone(), "next_action_index": index.clone()} if sarsa else {}
    never = torch.zeros((n,), dtype=torch.bool, device=device)
    return TransitionBatch(state=s0, action=action, reward=torch.ones((n,), device=device),
                           next_state=s0.clone(), terminated=never, truncated=never.clone(),
                           action_index=index, **extra)


def fixed_point_q(learner_cls, gamma: float, device=None) -> float:
    """Q(s0, a0) of `learner_cls` (DQN, Double DQN or deep SARSA) after 800
    learns at the reference's settings (one round of 32, lr 3e-3, a hard
    target update every learn) on a 64-row buffer of the self-loop
    transition; SARSA's buffer takes the batch twice, since a push commits
    the previous one."""
    device = resolve_device(device)
    space = DiscreteActionSpace.discrete(2)
    learner = learner_cls(training_rounds=1, batch_size=32, learning_rate=3e-3,
                          discount_factor=gamma, target_update_freq=1,
                          soft_update_tau=1.0).bind(space)
    sarsa = learner.on_policy
    buffer = SARSAReplayBuffer(capacity=64, num_envs=64) if sarsa else BasicReplayBuffer(64)
    batch = _self_loop_batch(sarsa, device)
    buffer_state = buffer.init(tree_map(lambda x: x[:1], batch))
    for _ in range(2 if sarsa else 1):
        buffer_state = buffer.push(buffer_state, batch)
    state = learner.init(torch.Generator().manual_seed(0), 4, space, 2, device)
    generator = make_generator(1, device)
    for _ in range(800):
        state, buffer_state, _ = learner.learn(state, buffer, buffer_state, generator)
    with torch.no_grad():
        q = learner.q_network.q_all(state.params, batch.state[:1], state.action_reps[None])
    return q[0, 0].item()
