"""The single-item recommender env, batched over users (port of
`pearl_tpu/envs/recsys.py`).

Every step the agent recommends one item of a slate of `slate_size`
candidates from a fixed catalog; the actions are the items' embeddings
(`DiscreteActionSpace.create(items)`) and the slate comes as
`available_actions_mask`. A frozen user model, p(click) =
sigmoid(3 * tanh([mean(history), item] @ w1 + b1) @ w2), gives a Bernoulli
click, which is the reward and the observation; the recommended item joins
the user's history; an episode lasts `episode_length` steps.

`step` draws the click's uniform and the next slate from the generator its
state keeps and calls `_transition`, which tests feed with the JAX package's
draws. A slate is the top `slate_size` of uniform noise over the catalog:
`slate_size` distinct items, uniformly, with no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from pearl_tpu_torch.api.environment import Environment
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace
from pearl_tpu_torch.api.types import ActionResult


@dataclasses.dataclass
class RecSysState:
    history: torch.Tensor  # (B, history_length, item_dim) recently shown items
    slate_mask: torch.Tensor  # (B, num_items) bool, the current slate
    last_click: torch.Tensor  # (B,) f32
    t: torch.Tensor  # (B,) i32
    generator: Optional[torch.Generator] = None  # the clicks and slates, on the device


@dataclasses.dataclass(frozen=True, eq=False)
class RecommenderEnvironment(Environment):
    """Build with `RecommenderEnvironment.create(generator, ...)`, or from a
    JAX env with `utils.jax_params.recommender_env_from_jax`."""

    items: torch.Tensor  # (num_items, item_dim) catalog embeddings
    w1: torch.Tensor  # (2 * item_dim, hidden) user-model weights
    b1: torch.Tensor  # (hidden,)
    w2: torch.Tensor  # (hidden,)
    slate_size: int = 2
    episode_length: int = 20
    history_length: int = 8
    logit_scale: float = 3.0

    @classmethod
    def create(
        cls,
        generator: torch.Generator,
        *,
        num_items: int = 100,
        item_dim: int = 16,
        hidden: int = 32,
        slate_size: int = 2,
        episode_length: int = 20,
        history_length: int = 8,
        device=None,
    ) -> "RecommenderEnvironment":
        """The catalog and the user model drawn from `generator` on its
        device, and placed on `device` (the generator's by default): a CPU
        generator gives the same catalog whatever device the env runs on."""
        device = generator.device if device is None else torch.device(device)

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=generator.device).to(device)

        return cls(
            items=normal(num_items, item_dim),
            w1=normal(2 * item_dim, hidden) / math.sqrt(2.0 * item_dim),
            b1=torch.zeros((hidden,), device=device),
            w2=normal(hidden) / math.sqrt(hidden),
            slate_size=slate_size,
            episode_length=episode_length,
            history_length=history_length,
        )

    @property
    def num_items(self) -> int:
        return int(self.items.shape[0])

    @property
    def item_dim(self) -> int:
        return int(self.items.shape[1])

    @property
    def action_space(self) -> DiscreteActionSpace:
        # The actions are the items' embeddings: use
        # IdentityActionRepresentation.
        return DiscreteActionSpace.create(self.items)

    @property
    def observation_space(self) -> BoxSpace:
        return BoxSpace.create([0.0], [1.0])

    @property
    def max_episode_steps(self) -> int:
        return self.episode_length

    def click_probability(self, history: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
        """The frozen user model: p(click | history, item), (B,)."""
        x = torch.cat([history.mean(dim=1), item], dim=-1)
        z = torch.tanh(x @ self.w1 + self.b1) @ self.w2
        return torch.sigmoid(self.logit_scale * z)

    def _slate(self, num_envs: int, generator: torch.Generator, device) -> torch.Tensor:
        noise = torch.rand((num_envs, self.num_items), generator=generator, device=device)
        idx = noise.topk(self.slate_size, dim=-1).indices
        mask = torch.zeros((num_envs, self.num_items), dtype=torch.bool, device=device)
        return mask.scatter_(1, idx, True)

    def reset(self, num_envs, generator, device) -> Tuple[RecSysState, torch.Tensor]:
        state = RecSysState(
            history=torch.zeros((num_envs, self.history_length, self.item_dim), device=device),
            slate_mask=self._slate(num_envs, generator, device),
            last_click=torch.zeros((num_envs,), device=device),
            t=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            generator=generator,
        )
        return state, torch.zeros((num_envs, 1), device=device)

    def _transition(self, state: RecSysState, action: torch.Tensor, click_u: torch.Tensor,
                    slate: torch.Tensor):
        """`click_u` (B,): uniform on [0, 1), a click where below p;
        `slate` (B, num_items) bool: the next slate."""
        item = action.reshape(action.shape[0], self.item_dim)
        p = self.click_probability(state.history, item)
        click = (click_u < p).to(torch.float32)
        history = torch.cat([state.history[:, 1:], item[:, None]], dim=1)
        t = state.t + 1
        new_state = dataclasses.replace(
            state, history=history, slate_mask=slate, last_click=click, t=t
        )
        result = ActionResult(
            observation=click[:, None],
            reward=click,
            terminated=t >= self.episode_length,
            truncated=torch.zeros_like(t, dtype=torch.bool),
            available_actions_mask=slate,
        )
        return new_state, result

    def step(self, state: RecSysState, action: torch.Tensor):
        B, device = action.shape[0], action.device
        click_u = torch.rand((B,), generator=state.generator, device=device)
        return self._transition(state, action, click_u, self._slate(B, state.generator, device))
