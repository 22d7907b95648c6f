"""History summarization modules (port of
`pearl_tpu/history_summarization_modules/modules.py`).

Protocol, batched over B envs:

    init_params(generator, obs_dim, action_repr_dim, device) -> params
        ({} if none, else an `nn.Module` on `device`)
    init_carry(num_envs, obs_dim, action_repr_dim, device) -> carry
    observe(carry, obs, action_repr) -> carry'
    reset_envs(carry, done_mask) -> carry'
    stored(carry) -> (B, stored_dim)      what replay stores
    forward(params, stored) -> (B, subjective_dim)

Replay stores the raw window (action-observation pairs, flattened), and the
learned summarizers (LSTM, transformer) run their forward again over sampled
windows inside the learner's loss, so the policy loss trains them.

The learned networks draw their initial weights from flax's distributions
(lecun-normal kernels, orthogonal recurrent kernels, zero biases, a
normal(0.02) positional table), and compute as flax does: the LSTM's gates in
the order (i, f, g, o) with ONE bias per gate (flax's recurrent bias; torch's
input bias is held at zero and trains nothing), layer norm with eps 1e-6 and
the variance as E[x^2] - E[x]^2, the tanh approximation of gelu, the query
scaled by head_dim ** -0.5 and masked logits at the float32 minimum.
"""

from __future__ import annotations

import abc
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from pearl_tpu_torch.neural_networks.common import LayerNorm, dense, lecun_normal_


class HistorySummarizationModule(abc.ABC):
    def init_params(self, generator, obs_dim: int, action_repr_dim: int, device=None):
        return {}

    @abc.abstractmethod
    def init_carry(self, num_envs: int, obs_dim: int, action_repr_dim: int, device):
        ...

    @abc.abstractmethod
    def observe(self, carry, obs, action_repr):
        ...

    @abc.abstractmethod
    def reset_envs(self, carry, done_mask):
        ...

    @abc.abstractmethod
    def stored(self, carry) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def forward(self, params, stored: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def subjective_dim(self, obs_dim: int, action_repr_dim: int) -> int:
        ...

    def stored_dim(self, obs_dim: int, action_repr_dim: int) -> int:
        return self.subjective_dim(obs_dim, action_repr_dim)

    @property
    def has_params(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class IdentityHistorySummarization(HistorySummarizationModule):
    """Subjective state = latest observation."""

    def init_carry(self, num_envs, obs_dim, action_repr_dim, device):
        return torch.zeros((num_envs, obs_dim), device=device)

    def observe(self, carry, obs, action_repr):
        del action_repr
        return obs

    def reset_envs(self, carry, done_mask):
        return carry  # the next observe overwrites it

    def stored(self, carry):
        return carry

    def forward(self, params, stored):
        return stored

    def subjective_dim(self, obs_dim, action_repr_dim):
        return obs_dim


def _append(carry: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """The (B, T, E) window shifted one step, `entry` (B, E) newest."""
    return torch.cat([carry[:, 1:], entry[:, None, :]], dim=1)


def _pair(carry: torch.Tensor, obs: torch.Tensor, action_repr) -> torch.Tensor:
    """The (action representation, observation) entry; a zero action on the
    observe that seeds a window."""
    if action_repr is None:
        action_repr = obs.new_zeros(obs.shape[:-1] + (carry.shape[-1] - obs.shape[-1],))
    return torch.cat([action_repr, obs], dim=-1)


def _zero_done(carry: torch.Tensor, done_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(done_mask[:, None, None], 0.0, carry)


@dataclasses.dataclass(frozen=True)
class StackingHistorySummarization(HistorySummarizationModule):
    """FIFO window of (action representation, observation) pairs, flattened;
    zero-padded at an episode's start. `include_action=False` stacks
    observations only (the Atari frame stack, the shape `VisualReplayBuffer`
    and the CNN's `time_major_stack` take)."""

    history_length: int = 8
    include_action: bool = True

    def _entry_dim(self, obs_dim, action_repr_dim):
        return obs_dim + (action_repr_dim if self.include_action else 0)

    def init_carry(self, num_envs, obs_dim, action_repr_dim, device):
        return torch.zeros(
            (num_envs, self.history_length, self._entry_dim(obs_dim, action_repr_dim)),
            device=device,
        )

    def observe(self, carry, obs, action_repr):
        entry = _pair(carry, obs, action_repr) if self.include_action else obs
        return _append(carry, entry.to(carry.dtype))

    def reset_envs(self, carry, done_mask):
        return _zero_done(carry, done_mask)

    def stored(self, carry):
        return carry.reshape(carry.shape[0], -1)

    def forward(self, params, stored):
        return stored

    def subjective_dim(self, obs_dim, action_repr_dim):
        return self.history_length * self._entry_dim(obs_dim, action_repr_dim)


class _PairWindow(HistorySummarizationModule):
    """The window of the learned summarizers: (action representation,
    observation) pairs, stored flattened."""

    history_length: int

    @property
    def has_params(self) -> bool:
        return True

    def init_carry(self, num_envs, obs_dim, action_repr_dim, device):
        return torch.zeros(
            (num_envs, self.history_length, obs_dim + action_repr_dim), device=device
        )

    def observe(self, carry, obs, action_repr):
        return _append(carry, _pair(carry, obs, action_repr))

    def reset_envs(self, carry, done_mask):
        return _zero_done(carry, done_mask)

    def stored(self, carry):
        return carry.reshape(carry.shape[0], -1)

    def forward(self, params, stored):
        return params(stored.reshape(stored.shape[0], self.history_length, -1))

    def stored_dim(self, obs_dim, action_repr_dim):
        return self.history_length * (obs_dim + action_repr_dim)


class LSTMNet(nn.Module):
    """`num_layers` stacked LSTMs over the (B, T, F) window; the summary is
    the last layer's output at the last step. One `nn.LSTM` (cuDNN on the
    card). Its input biases `bias_ih_l*` stay zero and out of `parameters()`:
    flax's cell has one bias per gate, and two biases that take the same
    gradient would move twice as far under Adam."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int, generator=None):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.lstm = nn.LSTM(
            input_dim, hidden_dim, num_layers, batch_first=True, device="meta"
        ).to_empty(device="cpu")
        H = hidden_dim
        with torch.no_grad():
            for k in range(num_layers):
                lecun_normal_(self.weight_ih(k), input_dim if k == 0 else H, generator)
                for g in range(4):  # each gate's recurrent kernel orthogonal
                    block = torch.empty(H, H)
                    nn.init.orthogonal_(block, generator=generator)
                    self.weight_hh(k)[g * H:(g + 1) * H].copy_(block.T)
                self.bias_hh(k).zero_()
                self.bias_ih(k).zero_()
                self.bias_ih(k).requires_grad_(False)

    def weight_ih(self, k):
        return getattr(self.lstm, f"weight_ih_l{k}")

    def weight_hh(self, k):
        return getattr(self.lstm, f"weight_hh_l{k}")

    def bias_hh(self, k):
        return getattr(self.lstm, f"bias_hh_l{k}")

    def bias_ih(self, k):
        return getattr(self.lstm, f"bias_ih_l{k}")

    def parameters(self, recurse: bool = True):
        """The trainable parameters (the zero input biases are not)."""
        return (p for p in super().parameters(recurse) if p.requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(x)
        return out[:, -1]


@dataclasses.dataclass(frozen=True)
class LSTMHistorySummarization(_PairWindow):
    """LSTM over the window; the summary is its last output."""

    history_length: int = 8
    hidden_dim: int = 128
    num_layers: int = 2

    def init_params(self, generator, obs_dim, action_repr_dim, device=None):
        net = LSTMNet(obs_dim + action_repr_dim, self.hidden_dim, self.num_layers, generator)
        return net.to(device) if device is not None else net

    def subjective_dim(self, obs_dim, action_repr_dim):
        return self.hidden_dim


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """(1, length, dim): PE[p, 2i] = sin(p / 10000^(2i/d)), PE[p, 2i+1] =
    cos(p / 10000^(2i/d)), in float32 as the reference computes it."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32)
        * torch.tensor(-math.log(10000.0) / dim, dtype=torch.float32)
    )
    pe = torch.zeros((length, dim))
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: dim // 2])
    return pe[None]


class CausalSelfAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention(num_heads)` on (y, y) under a
    causal mask: `query`, `key`, `value` and `out` as (d, d) products whose
    weights are flax's (d, heads, d/heads) and (heads, d/heads, d) kernels
    reshaped."""

    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, dense(dim, dim, generator, xavier=False))

    def forward(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, d = y.shape
        h = self.num_heads
        split = lambda x: x.reshape(B, T, h, d // h)  # noqa: E731
        q = split(self.query(y)) / math.sqrt(d // h)
        k, v = split(self.key(y)), split(self.value(y))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits.to(torch.float32), dim=-1).to(v.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, T, d))


class TransformerNet(nn.Module):
    """Causal pre-norm transformer over the (B, T, F) window; the summary is
    the final layer norm of the last token. Submodules carry the flax names
    (`embed`, `ln1_i`, `attn_i`, `ln2_i`, `mlp1_i`, `mlp2_i`, `ln_f`)."""

    def __init__(
        self, input_dim: int, dim: int, num_layers: int, num_heads: int,
        history_length: int, positional_encoding: str, generator=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.embed = dense(input_dim, dim, generator, xavier=False)
        if positional_encoding == "sinusoidal":
            self.register_buffer("pos", sinusoidal_positions(history_length, dim))
        else:
            self.pos_embedding = nn.Parameter(torch.empty((1, history_length, dim)))
            with torch.no_grad():
                nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", CausalSelfAttention(dim, num_heads, generator))
            self.add_module(f"ln2_{i}", LayerNorm(dim))
            self.add_module(f"mlp1_{i}", dense(dim, 4 * dim, generator, xavier=False))
            self.add_module(f"mlp2_{i}", dense(4 * dim, dim, generator, xavier=False))
        self.ln_f = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        pos = self.pos_embedding if hasattr(self, "pos_embedding") else self.pos
        x = self.embed(x) + pos[:, :T]
        mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        for i in range(self.num_layers):
            y = getattr(self, f"ln1_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(y, mask)
            y = getattr(self, f"ln2_{i}")(x)
            y = F.gelu(getattr(self, f"mlp1_{i}")(y), approximate="tanh")
            x = x + getattr(self, f"mlp2_{i}")(y)
        return self.ln_f(x)[:, -1]


@dataclasses.dataclass(frozen=True)
class TransformerHistorySummarization(_PairWindow):
    """Causal transformer over the window; the last token's representation.
    `positional_encoding` is "learned" (a trainable table) or "sinusoidal"
    (fixed); anything else is a ValueError at `init_params`, as in the
    reference."""

    history_length: int = 8
    dim: int = 64
    num_layers: int = 2
    num_heads: int = 4
    positional_encoding: str = "learned"

    def init_params(self, generator, obs_dim, action_repr_dim, device=None):
        if self.positional_encoding not in ("learned", "sinusoidal"):
            raise ValueError(
                "positional_encoding must be 'learned' or 'sinusoidal', got "
                f"{self.positional_encoding!r}"
            )
        net = TransformerNet(
            obs_dim + action_repr_dim, self.dim, self.num_layers, self.num_heads,
            self.history_length, self.positional_encoding, generator,
        )
        return net.to(device) if device is not None else net

    def subjective_dim(self, obs_dim, action_repr_dim):
        return self.dim
