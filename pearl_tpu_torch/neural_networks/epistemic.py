"""Epistemic neural networks (port of `pearl_tpu/neural_networks/epistemic.py`).

- `MLPWithPrior`: a trainable MLP plus a frozen random prior MLP, scaled
  additively. The ensemble form is `EnsembleQValueNetwork`.
- `Epinet` (Osband et al., "Epistemic Neural Networks"): a trainable epinet
  over concat(features, z), its (B, out * index) output contracted with the
  index z ~ N(0, I), plus a frozen ensemble of `index_dim` prior nets over
  the features without gradient, weighted by z.

Params are a dict {"train": nn.Module, "prior": nn.Module} whose prior has
`requires_grad=False`; hand only "train" to an optimizer (the reference's
convention, with the prior outside the optimized tree). Gradients: the
epinet reads `features` with their gradient, the prior reads them without,
as the reference splits them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP
from pearl_tpu_torch.neural_networks.twin_critic import StackedMLP


@dataclasses.dataclass(frozen=True)
class MLPWithPrior:
    hidden_dims: Sequence[int] = (64, 64)
    output_dim: int = 1
    prior_scale: float = 0.3

    def init(self, generator, input_dim: int) -> dict:
        hidden = tuple(self.hidden_dims)
        train = MLP(input_dim, hidden, self.output_dim, generator=generator)
        prior = MLP(input_dim, hidden, self.output_dim, generator=generator)
        return {"train": train, "prior": prior.requires_grad_(False)}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            prior = params["prior"](x)
        return params["train"](x) + self.prior_scale * prior


class _EpinetMLP(nn.Module):
    """An `MLP` under the name `MLP_0` (flax `_EpinetMLP`)."""

    def __init__(self, input_dim, hidden_dims, output_dim, generator=None):
        super().__init__()
        self.MLP_0 = MLP(input_dim, hidden_dims, output_dim, generator=generator)

    def forward(self, x):
        return self.MLP_0(x)


class _PriorNets(nn.Module):
    """`members` prior `_EpinetMLP`s, stacked (flax's `vmap` of them)."""

    def __init__(self, members, input_dim, hidden_dims, output_dim, generator=None):
        super().__init__()
        self.MLP_0 = StackedMLP(members, input_dim, hidden_dims, output_dim, generator)

    def forward(self, x):
        return self.MLP_0(x)


@dataclasses.dataclass(frozen=True)
class Epinet:
    """`num_prior_nets` is the reference's field, accepted and, as there,
    never read: the prior ensemble has `index_dim` members."""

    index_dim: int = 8
    hidden_dims: Sequence[int] = (64,)
    output_dim: int = 1
    num_prior_nets: int = 8
    prior_scale: float = 0.3

    def init(self, generator, feature_dim: int) -> dict:
        train = _EpinetMLP(feature_dim + self.index_dim, tuple(self.hidden_dims),
                           self.output_dim * self.index_dim, generator)
        prior = _PriorNets(self.index_dim, feature_dim, (16,), self.output_dim, generator)
        return {"train": train, "prior": prior.requires_grad_(False)}

    def sample_index(self, generator: Optional[torch.Generator], device=None) -> torch.Tensor:
        """z ~ N(0, I) of shape (index_dim,)."""
        return torch.randn((self.index_dim,), generator=generator, device=device)

    def apply(self, params, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """features (B, f), z (index_dim,) -> (B, output_dim)."""
        B = features.shape[0]
        zb = z[None, :].expand(B, self.index_dim)
        out = params["train"](torch.cat([features, zb], dim=-1))
        out = out.reshape(B, self.output_dim, self.index_dim) @ z
        with torch.no_grad():
            prior_outs = params["prior"](features)  # (index_dim, B, out)
            prior = torch.einsum("k,kbo->bo", z, prior_outs)
        return out + self.prior_scale * prior
