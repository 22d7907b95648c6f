"""Actor-critic base (port of
`pearl_tpu/policy_learners/sequential_decision_making/actor_critic_base.py`).

Semantics kept from the reference:
- Separate actor, critic and history-summarizer optimizers: AdamW (weight
  decay 0.01, betas (0.9, 0.999), eps 1e-8) with their own learning rates.
  The actor's gradient reaches only the actor's parameters, the critic's
  only the critic's, and the summarizer gets the SUM of both losses'
  gradients. A summarizer without parameters takes no step.
- Both losses are taken at the OLD state: the actor loss through the old
  critic, the critic loss's next action from the old actor (or its target).
  Then actor, critic and summarizer step, then the targets soft-update
  (`t + tau * (s - t)`), then `post_update` runs on the new state.
- Delayed actor updates (`actor_update_freq`, TD3): the learn step counter is
  incremented first and the actor moves only when `step % freq == 0`. On a
  closed step the reference multiplies the actor's gradients and its update
  by 0: Adam's moments still decay and its count still advances, and weight
  decay is cancelled with the update. The port steps the optimizer with zero
  gradients at a learning rate of 0, which is that, exactly. The actor
  target's soft update is gated the same way.
- `act` on a discrete space: the actor's probabilities in float32, the
  greedy index on `exploit`, else the exploration module's draw over them
  (`PropensityExploration` by default), and the action is the space's
  element at that index. On a continuous space: the mean action
  (`exploit`), else a base action perturbed by the exploration module when
  it has `act_continuous` (DDPG, TD3), else a draw from the stochastic
  policy (SAC); the action index is a zero placeholder.
- The default actor is `VanillaActorNetwork`; bound to a continuous space it
  becomes a `GaussianActorNetwork` of the same widths (`actor`). The critic
  is action-valued when it has `q_both` (twin critics), else state-valued
  (PPO, REINFORCE).

Randomness: the learner's own draws (policy samples inside the losses, TD3's
target noise) come from a device `torch.Generator` in the state, seeded from
the init generator, where the reference splits its state key. `act` and
`learn` draw from the generator they are given. `act` and `learn_batch`
take optional pre-drawn noise (`noise=`): the tests hand both packages the
same numbers. `act`'s is standard normal (B, d) on a continuous space and
the exploration module's Gumbel noise (B, A) on a discrete one.
`learn_batch`'s is a dict with the keys "actor" (the actor loss's policy
sample), "critic" (the critic loss's next-action sample), "target" (TD3's
target-policy noise) and "alpha" (SAC's temperature step).

Differences by design: the targets are copies, never aliases of the online
networks (in place updates would move an alias too), the learn step counter
is a host integer, the space's elements and represented candidates are made
on the device once at init (`PolicyLearner.action_tensors`), and
`act_dtype`'s cast of the actor is a copy kept in the state and recast only
when the actor was written (`utils.pytree.synced_cast`).

Not ported: `pmean_axis` (ROADMAP Queue A, item 20).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from pearl_tpu_torch.action_representation_modules import (
    ActionRepresentationModule,
    OneHotActionRepresentation,
)
from pearl_tpu_torch.neural_networks.actor_networks import (
    GaussianActorNetwork,
    VanillaActorNetwork,
    standard_normal,
)
from pearl_tpu_torch.neural_networks.twin_critic import TwinCritic
from pearl_tpu_torch.policy_learners.exploration_modules.common import (
    ExplorationModule,
    PropensityExploration,
)
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.utils.pytree import soft_update, synced_cast

WEIGHT_DECAY = 0.01


@dataclasses.dataclass
class ActorCriticState:
    actor_params: nn.Module
    critic_params: Optional[nn.Module]
    actor_target_params: Optional[nn.Module]  # None when unused
    critic_target_params: Optional[nn.Module]  # None when unused
    summarizer_params: Any
    actor_opt: torch.optim.Optimizer
    critic_opt: Optional[torch.optim.Optimizer]
    summ_opt: Optional[torch.optim.Optimizer]  # None when the summarizer has no parameters
    explore_state: Any
    step: int  # learn_batch counter
    low: Optional[torch.Tensor]  # (d,) the action box on the device; None when discrete
    high: Optional[torch.Tensor]  # (d,)
    generator: torch.Generator  # the learner's own draws, on the device
    extra: Any = None  # per-algorithm state (SAC's temperature)
    action_elements: Optional[torch.Tensor] = None  # (A, a) on the device; None when continuous
    action_reps: Optional[torch.Tensor] = None  # (A, r) represented candidates
    # `actor_params` cast to `act_dtype`; None when `act_dtype` is unset.
    # Read it through `_act_actor`, which recasts it when the actor changed.
    act_actor: Optional[nn.Module] = None


def _parameters(params) -> List[nn.Parameter]:
    return list(params.parameters()) if isinstance(params, nn.Module) else []


def _adamw(params: List[nn.Parameter], lr, **options) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=WEIGHT_DECAY, **options
    )


def apply_grads(optimizer: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step with `grads` as the parameters' gradients."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()


def frozen_step(optimizer: torch.optim.Optimizer, params) -> None:
    """optax's step under a zero gate: zero gradients and a learning rate of
    0. Adam's moments decay and its count advances; the parameters stay
    exactly as they are (p * (1 - 0) and p - 0 * m / d are p)."""
    lrs = [group["lr"] for group in optimizer.param_groups]
    for group in optimizer.param_groups:
        group["lr"] = 0.0
    try:
        apply_grads(optimizer, params, [torch.zeros_like(p) for p in params])
    finally:
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr


@dataclasses.dataclass(frozen=True, kw_only=True, eq=False)
class ActorCriticBase(PolicyLearner):
    actor_network: Any = VanillaActorNetwork()
    critic_network: Any = TwinCritic()
    # No `act_continuous`: on a continuous space the policy's own sample.
    exploration: ExplorationModule = PropensityExploration()
    action_representation: ActionRepresentationModule = OneHotActionRepresentation()
    actor_learning_rate: float = 1e-3
    critic_learning_rate: float = 1e-3
    history_summarization_learning_rate: float = 1e-3
    discount_factor: float = 0.99
    actor_soft_update_tau: float = 0.005
    critic_soft_update_tau: float = 0.005
    actor_update_freq: int = 1  # TD3 delays actor updates
    training_rounds: int = 1
    batch_size: int = 256
    pmean_axis: Optional[str] = None
    # Act-path mixed precision (e.g. "bfloat16"): the acting forward runs on
    # a cast copy of the actor and cast inputs; actions return as float32.
    act_dtype: Optional[str] = None

    @property
    def use_actor_target(self) -> bool:
        return False

    @property
    def use_critic_target(self) -> bool:
        return True

    @property
    def is_continuous(self) -> bool:
        return self.action_space is not None and self.action_space.is_continuous

    @property
    def actor(self):
        """The actor network; the discrete softmax default becomes a Gaussian
        actor of the same widths on a continuous space."""
        if self.is_continuous and isinstance(self.actor_network, VanillaActorNetwork):
            return GaussianActorNetwork(hidden_dims=self.actor_network.hidden_dims)
        return self.actor_network

    def _require_ported(self) -> None:
        if self.pmean_axis is not None:
            raise NotImplementedError("pmean_axis is not ported yet (ROADMAP Queue A, item 20)")

    def _act_dtype(self) -> torch.dtype:
        dtype = getattr(torch, str(self.act_dtype), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"act_dtype {self.act_dtype!r} is not a torch dtype name")
        return dtype

    # ------------------------------------------------------------------ init
    def _init_actor(self, generator, subj_dim, rep_dim, num_actions) -> nn.Module:
        if self.is_continuous:
            return self.actor.init(generator, subj_dim, self.action_space.action_dim)
        return self.actor.init(generator, subj_dim, rep_dim, num_actions)

    def _init_critic(self, generator, subj_dim, rep_dim) -> Optional[nn.Module]:
        if self.critic_network is None:
            return None
        if hasattr(self.critic_network, "q_both"):
            # An action-value (twin) critic: TwinCritic, CNNTwinCritic.
            a_dim = self.action_space.action_dim if self.is_continuous else rep_dim
            return self.critic_network.init(generator, subj_dim, a_dim)
        return self.critic_network.init(generator, subj_dim)  # a state-value critic

    def actor_optimizer(self, params: List[nn.Parameter], device) -> torch.optim.Optimizer:
        return _adamw(params, self.actor_learning_rate)

    def init_extra(self, device):
        return None

    def init(self, generator, observation_dim: int, action_space, num_envs: int, device):
        self._require_ported()
        subj_dim, rep_dim, num_actions = self.dims(observation_dim, action_space)
        actor = self._init_actor(generator, subj_dim, rep_dim, num_actions).to(device)
        critic = self._init_critic(generator, subj_dim, rep_dim)
        critic = critic.to(device) if critic is not None else None
        elements = reps = low = high = None
        if self.is_continuous:
            low, high = action_space.low.to(device), action_space.high.to(device)
        else:
            elements, reps = self.action_tensors(device)
        summ_params = self.history_summarizer.init_params(generator, observation_dim, rep_dim)
        summ = _parameters(summ_params)
        act_actor = None
        if self.act_dtype is not None:
            act_actor = copy.deepcopy(actor).requires_grad_(False).to(self._act_dtype())
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        return ActorCriticState(
            actor_params=actor,
            critic_params=critic,
            actor_target_params=(
                copy.deepcopy(actor).requires_grad_(False) if self.use_actor_target else None
            ),
            critic_target_params=(
                copy.deepcopy(critic).requires_grad_(False)
                if self.use_critic_target and critic is not None
                else None
            ),
            summarizer_params=summ_params,
            actor_opt=self.actor_optimizer(list(actor.parameters()), device),
            critic_opt=(
                _adamw(list(critic.parameters()), self.critic_learning_rate)
                if critic is not None
                else None
            ),
            summ_opt=_adamw(summ, self.history_summarization_learning_rate) if summ else None,
            explore_state=self.exploration.init(num_envs),
            step=0,
            low=low,
            high=high,
            generator=torch.Generator(device=device).manual_seed(seed),
            extra=self.init_extra(device),
            action_elements=elements,
            action_reps=reps,
            act_actor=act_actor,
        )

    @staticmethod
    def represented_candidates(state: ActorCriticState, batch_size: int) -> torch.Tensor:
        """Every candidate action under the action representation, (B, A, r):
        a broadcast view of the (A, r) made at init, never a copy."""
        reps = state.action_reps
        return reps[None].expand((batch_size,) + tuple(reps.shape))

    # ------------------------------------------------------------------- act
    def _act_actor(self, state: ActorCriticState) -> nn.Module:
        """The actor the act path runs: `act_actor` recast if the actor was
        written since, or the actor itself without `act_dtype`."""
        if state.act_actor is None:
            return state.actor_params
        return synced_cast(state.act_actor, state.actor_params)

    @torch.no_grad()
    def act(
        self, state: ActorCriticState, subjective_state, mask, generator, exploit: bool = False,
        noise: Optional[torch.Tensor] = None,
    ):
        """On a continuous space `noise` (B, d) replaces the standard normal
        draw of the policy sample or of the exploration noise. Where the
        reference draws both (a stochastic actor under an exploration module)
        it draws them from one key, so they are the same numbers: here too.
        On a discrete space `noise` is the exploration module's (B, A)
        Gumbel noise."""
        self._require_ported()
        net = self.actor
        actor = self._act_actor(state)
        if state.act_actor is not None:
            subjective_state = subjective_state.to(self._act_dtype())
        if not self.is_continuous:
            return self._act_discrete(
                state, actor, subjective_state, mask, generator, exploit, noise
            )
        explore_state = state.explore_state
        low, high = state.low, state.high
        if exploit:
            if hasattr(net, "mean_action"):
                action = net.mean_action(actor, subjective_state, low, high)
            else:
                action = net.action(actor, subjective_state, low, high)
        elif hasattr(self.exploration, "act_continuous"):
            shape = (subjective_state.shape[0], low.shape[0])
            noise = standard_normal(shape, low, generator, noise)
            if hasattr(net, "action"):
                base = net.action(actor, subjective_state, low, high)
            else:
                base = net.sample_action(actor, subjective_state, generator, low, high, noise)[0]
            explore_state, action = self.exploration.act_continuous(
                explore_state, base, low, high, generator, noise=noise
            )
        else:
            action, _ = net.sample_action(actor, subjective_state, generator, low, high, noise)
        action = action.to(torch.float32)
        index = torch.zeros(action.shape[:1], dtype=torch.int32, device=action.device)
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=action, index=index),
        )

    def _act_discrete(self, state, actor, subjective_state, mask, generator, exploit, noise):
        candidates = self.represented_candidates(state, subjective_state.shape[0])
        if state.act_actor is not None:
            candidates = candidates.to(self._act_dtype())
        probs = self.actor.get_policy_distribution(
            actor, subjective_state, candidates, mask
        ).to(torch.float32)
        exploit_index = self.greedy_index(probs, mask, state.generator)
        explore_state = state.explore_state
        if exploit:
            index = exploit_index
        else:
            extra = {} if noise is None else {"noise": noise}
            explore_state, index = self.exploration.act(
                explore_state, probs, exploit_index, mask, generator, **extra
            )
        return (
            dataclasses.replace(state, explore_state=explore_state),
            ActionChoice(action=state.action_elements[index.long()], index=index),
        )

    # ----------------------------------------------------------------- learn
    def actor_loss(self, state, actor_params, batch, subj, noise: Dict) -> torch.Tensor:
        raise NotImplementedError

    def critic_loss(
        self, state, critic_params, batch, subj, next_subj, noise: Dict
    ) -> torch.Tensor:
        raise NotImplementedError

    def learn_batch(
        self, state: ActorCriticState, batch: TransitionBatch,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ):
        noise = noise or {}
        summ = self.history_summarizer
        summ_list = _parameters(state.summarizer_params)
        actor_list = list(state.actor_params.parameters())
        step = state.step + 1
        do_actor = step % self.actor_update_freq == 0

        # Both losses at the old state, before any parameter moves.
        a_wrt = (actor_list if do_actor else []) + summ_list
        with torch.set_grad_enabled(bool(a_wrt)):
            subj = summ.forward(state.summarizer_params, batch.state)
            a_loss = self.actor_loss(state, state.actor_params, batch, subj, noise)
        a_grads = torch.autograd.grad(a_loss, a_wrt) if a_wrt else []
        summ_grads = a_grads[len(a_wrt) - len(summ_list):]
        metrics = {"actor_loss": a_loss.detach()}
        if state.critic_params is not None:
            critic_list = list(state.critic_params.parameters())
            subj = summ.forward(state.summarizer_params, batch.state)
            with torch.no_grad():
                next_subj = summ.forward(state.summarizer_params, batch.next_state)
            c_loss = self.critic_loss(state, state.critic_params, batch, subj, next_subj, noise)
            c_grads = torch.autograd.grad(c_loss, critic_list + summ_list)
            summ_grads = [a + c for a, c in zip(summ_grads, c_grads[len(critic_list):])]
            metrics["critic_loss"] = c_loss.detach()

        if do_actor:
            apply_grads(state.actor_opt, actor_list, a_grads[: len(actor_list)])
        else:
            frozen_step(state.actor_opt, actor_list)
        if state.critic_params is not None:
            apply_grads(state.critic_opt, critic_list, c_grads[: len(critic_list)])
        if state.summ_opt is not None:
            apply_grads(state.summ_opt, summ_list, summ_grads)

        if state.actor_target_params is not None and do_actor:
            soft_update(state.actor_target_params, state.actor_params, self.actor_soft_update_tau)
        if state.critic_target_params is not None:
            soft_update(
                state.critic_target_params, state.critic_params, self.critic_soft_update_tau
            )
        new_state, extra_metrics = self.post_update(
            dataclasses.replace(state, step=step), batch, noise
        )
        return new_state, {**metrics, **extra_metrics}

    def post_update(self, state: ActorCriticState, batch: TransitionBatch, noise: Dict):
        """Hook for per-update extra state (SAC's temperature)."""
        return state, {}

    def episode_reset(self, state, done_mask, generator):
        return dataclasses.replace(
            state,
            explore_state=self.exploration.reset(state.explore_state, done_mask, generator),
        )
