"""PearlAgent: policy learner + safety module + history summarization +
replay buffer (port of `pearl_tpu/agent/pearl_agent.py`).

Every function is batched over `num_envs` envs on one device, and
`AgentState` is one dataclass carrying every module's state. `observe` pushes
history summaries; a done env's transition keeps the summarizer's state after
the terminal observation as `next_state`, and the post-reset observation only
seeds that env's next window.

With a `FrameRingHistorySummarization` the agent takes the frame path
(`_observe_frames`): a step's history and replay traffic is two single
frames and one in-place ring write, and the stacked windows are never made.
When the paired CNN has `conv1_cache=True` the agent also owns the conv1
contribution cache of `ops/conv_cache.py`, held in `history_carry.cache` and
written in place: seeded at `init`, one `cache_write` per observe, a full
refresh after every `learn`. As in the reference these are the only
refreshes: conv1 weights loaded into `learner.params` between them leave a
stale cache until the next `learn`; call
`q_network.refresh_cache(params, history_carry)` after such a load.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.ops.conv_cache import cache_write
from pearl_tpu_torch.ops.layout_fence import copy_fence
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.safety_modules import (
    IdentitySafetyModule,
    RiskSensitiveSafetyModule,
    SafetyModule,
)
from pearl_tpu_torch.utils import profiling
from pearl_tpu_torch.utils.device import DeviceLike, resolve_device
from pearl_tpu_torch.utils.pytree import tree_select


@dataclasses.dataclass
class AgentState:
    learner: Any
    safety: Any
    replay: Any
    history_carry: Any
    available_mask: Optional[torch.Tensor]  # (B, A) current availability
    last_action: ActionChoice


@dataclasses.dataclass(frozen=True, eq=False)
class PearlAgent:
    policy_learner: PolicyLearner
    replay_buffer: BasicReplayBuffer = dataclasses.field(
        default_factory=lambda: BasicReplayBuffer(capacity=10_000)
    )
    safety_module: SafetyModule = dataclasses.field(default_factory=IdentitySafetyModule)
    # Store the (B, A) availability masks before and after each step in
    # replay (dynamic action spaces), and the env's per-step cost (the
    # reward-constrained safety module learns from it).
    track_available_masks: bool = False
    store_cost: bool = False

    def __post_init__(self):
        """Safety-module injection, as in the reference: a distributional
        learner acts under a risk metric, so a risk-sensitive module given to
        the agent replaces the learner's `safety`; the untouched default
        resolves to the learner's own module, so both views agree; any other
        module is a TypeError."""
        learner = self.policy_learner
        if learner.is_distributional and hasattr(learner, "safety"):
            if isinstance(self.safety_module, RiskSensitiveSafetyModule):
                object.__setattr__(
                    self, "policy_learner", dataclasses.replace(learner, safety=self.safety_module)
                )
            elif type(self.safety_module) is IdentitySafetyModule:
                object.__setattr__(self, "safety_module", learner.safety)
            else:
                raise TypeError(
                    "A distributional policy learner requires a risk-sensitive safety "
                    f"module; got {type(self.safety_module).__name__}."
                )
        self._frame_path  # a frame-ring summarizer's pairing is checked here

    @property
    def _frame_path(self) -> bool:
        """Visual fast path: a frame-ring summarizer paired with a frame-push
        replay buffer and a ring-aware Q-network. A frame-ring summarizer
        with anything else is a TypeError."""
        summ = self.policy_learner.history_summarizer
        if not getattr(summ, "is_frame_ring", False):
            return False
        if not getattr(self.replay_buffer, "supports_frame_push", False):
            raise TypeError(
                "FrameRingHistorySummarization requires a frame-push replay "
                "buffer (VisualReplayBuffer): the generic path would "
                "materialize the stacked window every step, which is the "
                "traffic the ring eliminates. Got "
                f"{type(self.replay_buffer).__name__}."
            )
        net = getattr(self.policy_learner, "q_network", None)
        if not getattr(net, "supports_frame_ring", False):
            raise TypeError(
                "FrameRingHistorySummarization requires a ring-aware "
                "q-network (CNNQValueNetwork(time_major_stack=True)): other "
                "nets cannot consume the circular FrameRingView the ring "
                f"hands them. Got {type(net).__name__}."
            )
        return True

    @property
    def _cache_net(self):
        """The ring-aware CNN when its conv1-cache act path is enabled, else
        None."""
        if not self._frame_path:
            return None
        net = self.policy_learner.q_network
        return net if getattr(net, "cache_enabled", False) else None

    def cache_params(self, learner_state):
        """The learner's Q-network module when a conv1 cache needs it to be
        seeded, else None: only that path reads `learner_state.params`, which
        an actor-critic learner's state does not have."""
        return learner_state.params if self._cache_net is not None else None

    # ------------------------------------------------------------------ setup
    def for_env(self, env) -> "PearlAgent":
        """Bind the learner to the env's action space."""
        return dataclasses.replace(
            self, policy_learner=self.policy_learner.bind(env.action_space)
        )

    @property
    def _summ(self):
        return self.policy_learner.history_summarizer

    def _rep_dims(self, observation_dim: int):
        learner = self.policy_learner
        space = learner.action_space
        num_actions = getattr(space, "n", 0)
        rep = learner.resolved_action_representation(space)
        rep_dim = rep.representation_dim(space.action_dim, num_actions)
        return rep, rep_dim, num_actions

    def fresh_per_env_state(
        self, observation_dim: int, num_envs: int, initial_obs: torch.Tensor, device,
        params=None,
    ) -> dict:
        """The per-env leaves of `AgentState` for a fresh batch of envs.
        `params` (the learner's Q-network module) seeds the conv1 cache and
        is needed only by a network with `conv1_cache=True`."""
        _, rep_dim, num_actions = self._rep_dims(observation_dim)
        carry = self._summ.init_carry(num_envs, observation_dim, rep_dim, device)
        carry = self._summ.observe(carry, initial_obs, None)
        net = self._cache_net
        if net is not None:
            if params is None:
                raise ValueError("a conv1_cache network needs `params` to seed its cache")
            carry = dataclasses.replace(carry, cache=net.refresh_cache(params, carry))
        mask = (
            torch.ones((num_envs, num_actions), dtype=torch.bool, device=device)
            if num_actions
            else None
        )
        action_dim = self.policy_learner.action_space.action_dim
        last = ActionChoice(
            action=torch.zeros((num_envs, action_dim), device=device),
            index=torch.zeros((num_envs,), dtype=torch.int32, device=device),
        )
        return {"history_carry": carry, "available_mask": mask, "last_action": last}

    def init(
        self,
        seed: int,
        observation_dim: int,
        num_envs: int,
        initial_obs: torch.Tensor,
        device: DeviceLike = None,
    ) -> AgentState:
        """Fresh state on `device` (the card unless `device="cpu"`); the
        weights are drawn from a CPU generator seeded with `seed`."""
        device = resolve_device(device)
        learner = self.policy_learner
        space = learner.action_space
        _, rep_dim, num_actions = self._rep_dims(observation_dim)
        gen = torch.Generator().manual_seed(int(seed))
        learner_state = learner.init(gen, observation_dim, space, num_envs, device)
        safety_state = self.safety_module.init(gen, observation_dim, space, num_envs, device)

        stored_dim = self._summ.stored_dim(observation_dim, rep_dim)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        masks = (
            zeros(1, num_actions, dtype=torch.bool)
            if self.track_available_masks and num_actions
            else None
        )
        example = TransitionBatch(
            state=zeros(1, stored_dim),
            action=zeros(1, space.action_dim),
            reward=zeros(1),
            next_state=zeros(1, stored_dim),
            terminated=zeros(1, dtype=torch.bool),
            truncated=zeros(1, dtype=torch.bool),
            action_index=zeros(1, dtype=torch.int32),
            curr_available_mask=masks,
            next_available_mask=masks,
            cost=zeros(1) if self.store_cost else None,
            **self._extra_example_fields(space, device),
        )
        return AgentState(
            learner=learner_state,
            safety=safety_state,
            replay=self.replay_buffer.init(example),
            **self.fresh_per_env_state(
                observation_dim, num_envs, initial_obs.to(device), device,
                params=self.cache_params(learner_state),
            ),
        )

    def _extra_example_fields(self, space, device) -> dict:
        """Storage columns the replay buffer adds (SARSA's next action)."""
        extra = getattr(self.replay_buffer, "extra_example_fields", None)
        return extra(space, device) if extra is not None else {}

    # ------------------------------------------------------------------- act
    @torch.no_grad()
    def subjective_state(self, astate: AgentState) -> torch.Tensor:
        """The summary the policy acts on. Acting trains nothing, so a learned
        summarizer's forward records no graph."""
        stored = self._summ.stored(astate.history_carry)
        return self._summ.forward(astate.learner.summarizer_params, stored)

    def act(
        self, astate: AgentState, generator: Optional[torch.Generator], exploit: bool = False
    ) -> Tuple[AgentState, ActionChoice]:
        with profiling.span("agent.act"):
            subjective = self.subjective_state(astate)
            mask = self.safety_module.filter_action(
                astate.safety, subjective, astate.available_mask
            )
            learner_state, choice = self.policy_learner.act(
                astate.learner, subjective, mask, generator, exploit
            )
            return dataclasses.replace(astate, learner=learner_state, last_action=choice), choice

    # --------------------------------------------------------------- observe
    def observe(
        self,
        astate: AgentState,
        result: ActionResult,
        next_obs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> AgentState:
        """Ingest a batched env step: update history, push the transition,
        reset per-env state where episodes ended."""
        with profiling.span("agent.observe"):
            if self._frame_path:
                return self._observe_frames(astate, result, next_obs, generator)
            astate, transition = self.observe_deferred(astate, result, next_obs, generator)
            with profiling.span("replay.push"):
                profiling.count("replay.rows_pushed", result.reward.shape[0])
                replay_state = self.replay_buffer.push(astate.replay, transition, generator)
            return dataclasses.replace(astate, replay=replay_state)

    def _observe_frames(
        self,
        astate: AgentState,
        result: ActionResult,
        next_obs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> AgentState:
        """Frame-ring observe: the acting observation is read from the ring,
        the post-step observation comes from the env, and one frame is
        written into the ring, O(frame) instead of O(window) per step."""
        summ = self._summ
        done = result.done
        with profiling.span("history.advance"):
            # `advance` writes the ring in place (with history_length == 1
            # into the very slot `newest_frame` views), so the acting frame
            # is copied out first.
            frame_s = copy_fence(summ.newest_frame(astate.history_carry))
            carry_next = summ.advance(astate.history_carry, result.observation, next_obs, done)
            net = self._cache_net
            if net is not None:
                # The entry frame, where(done, next_obs, obs) in the ring's
                # dtype, is what `advance` just wrote at the OLD cursor: read
                # it back, take its contributions under the learner's current
                # conv1 weights, and scatter them along that slot's diagonal.
                slot = astate.history_carry.cursor
                with torch.no_grad():
                    y = net.cache_contrib_y(
                        astate.learner.params, copy_fence(carry_next.ring[:, slot])
                    )
                T, _, _, _, _, _, _, OC = net._conv1_dims()
                cache_write(carry_next.cache, y, slot, T=T, OC=OC)
        rest = TransitionBatch(
            state=None,
            action=astate.last_action.action,
            reward=result.reward,
            next_state=None,
            terminated=result.terminated,
            truncated=result.truncated,
            action_index=astate.last_action.index,
            **self._stored_columns(astate, result),
        )
        with profiling.span("replay.push"):
            profiling.count("replay.rows_pushed", result.reward.shape[0])
            replay_state = self.replay_buffer.push_frames(
                astate.replay, frame_s, result.observation, rest
            )
        return dataclasses.replace(
            astate,
            learner=self.policy_learner.episode_reset(astate.learner, done, generator),
            history_carry=carry_next,
            available_mask=self._next_mask(astate, result),
            replay=replay_state,
        )

    def _stored_columns(self, astate: AgentState, result: ActionResult) -> dict:
        """The optional replay columns of a step: the availability masks at
        act time and after the step, and the step's cost."""
        columns = {}
        if self.track_available_masks:
            columns["curr_available_mask"] = astate.available_mask
            columns["next_available_mask"] = result.available_actions_mask
        if self.store_cost:
            columns["cost"] = result.cost
        return columns

    @staticmethod
    def _next_mask(astate: AgentState, result: ActionResult) -> Optional[torch.Tensor]:
        """where(done, all available, the env's mask or all available)."""
        if astate.available_mask is None:
            return None
        full = torch.ones_like(astate.available_mask)
        if result.available_actions_mask is None:
            return full
        return torch.where(result.done[:, None], full, result.available_actions_mask)

    def observe_deferred(
        self,
        astate: AgentState,
        result: ActionResult,
        next_obs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[AgentState, TransitionBatch]:
        """`observe` without the replay push: returns (astate', transition)."""
        if self._frame_path:
            raise ValueError(
                "the frame-ring visual path pushes per step (frame "
                "reconstruction needs one row per env per push); deferred "
                "pushes are not supported"
            )
        summ = self._summ
        learner = self.policy_learner
        rep = learner.resolved_action_representation(learner.action_space)

        with profiling.span("history.advance"):
            prev_stored = summ.stored(astate.history_carry)
            act_rep = rep.apply(astate.last_action.action)
            carry_after = summ.observe(astate.history_carry, result.observation, act_rep)
            next_stored = summ.stored(carry_after)
            done = result.done
            # Asynchronous per-env episode resets: zero the window and seed
            # it with the post-reset observation.
            zeroed = summ.reset_envs(carry_after, done)
            fresh = summ.observe(zeroed, next_obs, None)
            carry_next = tree_select(done, fresh, carry_after)

        transition = TransitionBatch(
            state=prev_stored,
            action=astate.last_action.action,
            reward=result.reward,
            next_state=next_stored,
            terminated=result.terminated,
            truncated=result.truncated,
            action_index=astate.last_action.index,
            **self._stored_columns(astate, result),
        )

        learner_state = learner.episode_reset(astate.learner, done, generator)
        astate = dataclasses.replace(
            astate,
            learner=learner_state,
            history_carry=carry_next,
            available_mask=self._next_mask(astate, result),
        )
        return astate, transition

    # ----------------------------------------------------------------- learn
    def learn(
        self,
        astate: AgentState,
        generator: Optional[torch.Generator],
        indices: Optional[torch.Tensor] = None,
    ) -> Tuple[AgentState, dict]:
        """`training_rounds` learn steps from replay; `indices`
        (training_rounds, batch_size) replaces the sampled rows. A safety
        module with a `batch_transform` (reward shaping) hands it to the
        learner, and one with `learn` then updates from replay under the
        learner's new state."""
        with profiling.span("agent.learn"):
            safety = self.safety_module
            transform = getattr(safety, "batch_transform", None)
            extra = {} if transform is None else {"batch_transform": transform(astate.safety)}
            learner_state, replay_state, metrics = self.policy_learner.learn(
                astate.learner, self.replay_buffer, astate.replay, generator, indices=indices,
                **extra,
            )
            safety_state = astate.safety
            if hasattr(safety, "learn"):
                safety_state, s_metrics = safety.learn(
                    safety_state, self.replay_buffer, astate.replay, generator,
                    self.policy_learner, learner_state,
                )
                metrics = {**metrics, **s_metrics}
            if self.policy_learner.on_policy:
                replay_state = self.replay_buffer.clear(replay_state)
            net = self._cache_net
            if net is not None:
                # conv1's weights just moved: recompute every cached contribution
                # (in place) so the act path stays exact.
                net.refresh_cache(learner_state.params, astate.history_carry)
            return dataclasses.replace(
                astate, learner=learner_state, safety=safety_state, replay=replay_state
            ), metrics

    def learn_batch(self, astate: AgentState, batch: TransitionBatch):
        """Offline path: the safety module's `batch_transform` (if any), the
        learner's `preprocess_batch` and update, then the safety update on the
        transformed batch, in the reference's order."""
        transform = getattr(self.safety_module, "batch_transform", None)
        if transform is not None:
            batch = transform(astate.safety)(batch)
        learner_batch = self.policy_learner.preprocess_batch(astate.learner, batch)
        learner_state, metrics = self.policy_learner.learn_batch(astate.learner, learner_batch)
        safety_state, s_metrics = self.safety_module.learn_batch(
            astate.safety, batch, learner=self.policy_learner, learner_state=learner_state
        )
        return dataclasses.replace(astate, learner=learner_state, safety=safety_state), {
            **metrics,
            **s_metrics,
        }
