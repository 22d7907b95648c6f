"""Contextual-bandit models (port of
`pearl_tpu/neural_networks/contextual_bandit.py`).

`LinearRegression` keeps the sufficient statistics of a weighted least
squares problem, A = sum w x xT (+ ridge) and b = sum w x y, in a
`LinearRegressionState` of tensors. `append_ones` prepends the intercept
column, so A is (d+1, d+1). Solves go through a Cholesky factor of A plus a
1e-6 jitter, always (the reference's data-dependent inverse-or-pinv is
replaced by this branch-free solve in the JAX package too).

The statistics, their updates and the solves are float64 (the JAX package's
are float32); the products of coefficients and of the factor's inverse
with the feature rows stay in the features' dtype. In float32, one learn of
131072 rows in which every env took the same arm (a rank-deficient batch)
left A with a least eigenvalue of -0.67 on an H100 where the ridge puts 1:
the factor failed, the coefficients were NaN and every env took arm 0 from
then on.

Every statistic may carry leading batch axes: a state whose A is
(arms, d+1, d+1) holds one regression per arm (the disjoint container's
stack), and the methods take features with the same leading axes,
(arms, N, d). A state without them takes features of any leading shape.

No host sync: the factor is `cholesky_ex` without its error check, a solve
for the coefficients is a pair of triangular solves on it (what `cho_solve`
computes) and sigma goes through the factor's inverse, so acting and
learning never wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP, resolve_activation
from pearl_tpu_torch.utils.collectives import MeshAxis, check_pmean_axis, psum

JITTER = 1e-6
STATS_DTYPE = torch.float64


@dataclasses.dataclass
class LinearRegressionState:
    A: torch.Tensor  # (..., d+1, d+1)
    b: torch.Tensor  # (..., d+1)
    sum_weight: torch.Tensor  # (...)
    weight_since_discount: torch.Tensor  # (...), for periodic discounting


def append_ones(x: torch.Tensor) -> torch.Tensor:
    """Prepend the intercept column."""
    return torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)


@dataclasses.dataclass(frozen=True)
class LinearRegression:
    feature_dim: int  # WITHOUT the intercept column
    l2_reg_lambda: float = 1.0
    gamma: float = 1.0  # discounting multiplier (<1 enables discounting)
    apply_discounting_interval: float = 0.0  # in accumulated weight units
    # A `MeshAxis` over which the additive statistics of each update are
    # summed (data parallelism), or None.
    pmean_axis: Optional[MeshAxis] = None

    def __post_init__(self):
        check_pmean_axis(self.pmean_axis)

    @property
    def dim(self) -> int:
        return self.feature_dim + 1

    def _eye(self, device) -> torch.Tensor:
        return torch.eye(self.dim, dtype=STATS_DTYPE, device=device)

    def init(self, device=None, batch_shape=()) -> LinearRegressionState:
        zeros = torch.zeros(batch_shape, dtype=STATS_DTYPE, device=device)
        return LinearRegressionState(
            A=(self.l2_reg_lambda * self._eye(device)).expand(
                *batch_shape, self.dim, self.dim).clone(),
            b=torch.zeros((*batch_shape, self.dim), dtype=STATS_DTYPE, device=device),
            sum_weight=zeros,
            weight_since_discount=zeros.clone(),
        )

    def update(
        self,
        state: LinearRegressionState,
        x: torch.Tensor,
        y: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
    ) -> LinearRegressionState:
        """Weighted least-squares update: A += (x w)T x, symmetrised, and
        b += (x w)T y. x (..., N, d), y and weight (..., N); x and y may lack
        the state's batch axes (shared by every regression of the stack)."""
        x = append_ones(x).to(STATS_DTYPE)
        y = y.to(STATS_DTYPE)
        weight = torch.ones_like(y) if weight is None else weight.to(STATS_DTYPE)
        xw = x * weight[..., None]
        delta_A = xw.mT @ x
        delta_b = (xw * y[..., None]).sum(-2)
        delta_w = weight.sum(-1)
        # The statistics are additive: sum every rank's rows (float64).
        delta_A, delta_b, delta_w = psum([delta_A, delta_b, delta_w], self.pmean_axis)
        delta_A = (delta_A + delta_A.mT) / 2.0
        new = LinearRegressionState(
            A=state.A + delta_A,
            b=state.b + delta_b,
            sum_weight=state.sum_weight + delta_w,
            weight_since_discount=state.weight_since_discount + delta_w,
        )
        if self.gamma < 1.0 and self.apply_discounting_interval > 0:
            new = self._maybe_discount(new)
        return new

    def _maybe_discount(self, state: LinearRegressionState) -> LinearRegressionState:
        """Discount the data part of A, and b, by gamma whenever the weight
        accumulated since the last discount reaches the interval. The ridge
        prior is not discounted, nor is `sum_weight`."""
        do = state.weight_since_discount >= self.apply_discounting_interval
        scale = torch.where(do, self.gamma, 1.0)
        ridge = self.l2_reg_lambda * self._eye(state.A.device)
        return LinearRegressionState(
            A=(state.A - ridge) * scale[..., None, None] + ridge,
            b=state.b * scale[..., None],
            sum_weight=state.sum_weight,
            weight_since_discount=torch.where(do, 0.0, state.weight_since_discount),
        )

    def factor(self, state: LinearRegressionState) -> torch.Tensor:
        """The lower Cholesky factor L of A + jitter I (L LT = A)."""
        A = state.A + JITTER * self._eye(state.A.device)
        return torch.linalg.cholesky_ex(A, check_errors=False).L

    @staticmethod
    def _cho_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """(L LT)^-1 rhs for rhs (..., D, K), as two triangular solves."""
        z = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(L.mT, z, upper=True)

    def coefs(self, state: LinearRegressionState, L=None) -> torch.Tensor:
        """beta solving A beta = b, (..., d+1), in the statistics' dtype. `L`
        is the factor when the caller has it."""
        L = self.factor(state) if L is None else L
        return self._cho_solve(L, state.b[..., None])[..., 0]

    def predict(self, state: LinearRegressionState, x: torch.Tensor, L=None) -> torch.Tensor:
        """mu(x) = [1, x] . beta, for x (..., d) (with the state's batch axes
        leading, then one axis of rows)."""
        return (append_ones(x) @ self.coefs(state, L).to(x.dtype)[..., None])[..., 0]

    def calculate_sigma(self, state: LinearRegressionState, x: torch.Tensor,
                        L=None) -> torch.Tensor:
        """sigma(x) = sqrt(xT A^-1 x) = |L^-1 x| for x (..., d) as in
        `predict`: L^-1 is one triangular solve against the (D, D) identity,
        and the rows go through one product with it. (A triangular solve with
        the rows as its right-hand sides ran on the card as batched cuBLAS
        solves of one column each: 1.97M kernels and 13.8 s for the 655360
        rows of one act at 131072 envs.)"""
        L = self.factor(state) if L is None else L
        batch = state.A.shape[:-2]
        xe = append_ones(x).reshape(*batch, -1, self.dim)
        L_inv = torch.linalg.solve_triangular(L, self._eye(state.A.device), upper=False)
        z = xe @ L_inv.to(x.dtype).mT  # (..., M, D)
        return torch.sqrt((z * z).sum(-1)).reshape(x.shape[:-1])

    def mu_sigma(self, state: LinearRegressionState, x: torch.Tensor):
        """(`predict`, `calculate_sigma`) of x from one factor of A."""
        L = self.factor(state)
        return self.predict(state, x, L), self.calculate_sigma(state, x, L)

    def sample_coefs(
        self,
        state: LinearRegressionState,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Thompson sampling: beta ~ N(coefs, A^-1), as coefs + L^-T eps for
        eps ~ N(0, I), float32. `noise`, when given, is eps (..., d+1)."""
        L = self.factor(state)
        if noise is None:
            noise = torch.randn(state.b.shape, generator=generator, device=state.b.device)
        eps = noise.to(STATS_DTYPE)[..., None]
        delta = torch.linalg.solve_triangular(L.mT, eps, upper=True)[..., 0]
        return (self.coefs(state) + delta).to(torch.float32)


@dataclasses.dataclass
class NeuralLinearParams:
    """The trainable MLP feature extractor and end-to-end head, and the
    linear statistics over the learned features."""

    mlp: nn.Module
    head: nn.Module
    linreg: LinearRegressionState


@dataclasses.dataclass(frozen=True)
class NeuralLinearRegression:
    """MLP feature extractor (relu last activation) -> LinearRegression over
    the learned features (Neural LinUCB / LinTS). With `nn_e2e`, mu comes
    from an end-to-end one-output linear head and sigma from the statistics;
    without it both come from the statistics. mu is returned before
    `output_activation`: the learner places the activation around the
    exploration bonus."""

    feature_dim: int  # raw input dim
    hidden_dims: tuple = (64, 64)
    linear_feature_dim: int = 16  # learned-feature dim fed to LinearRegression
    nn_e2e: bool = True
    output_activation: str = "linear"

    def mlp(self, generator=None) -> MLP:
        return MLP(self.feature_dim, tuple(self.hidden_dims), self.linear_feature_dim,
                   generator=generator, last_activation="relu")

    def head(self, generator=None) -> MLP:
        return MLP(self.linear_feature_dim, (), 1, generator=generator)

    def linear_regression(self, pmean_axis=None) -> LinearRegression:
        return LinearRegression(feature_dim=self.linear_feature_dim, pmean_axis=pmean_axis)

    def init(self, generator, device) -> NeuralLinearParams:
        return NeuralLinearParams(
            mlp=self.mlp(generator).to(device),
            head=self.head(generator).to(device),
            linreg=self.linear_regression().init(device),
        )

    def features(self, params: NeuralLinearParams, x: torch.Tensor) -> torch.Tensor:
        """The learned features of x (N, f): (N, linear_feature_dim)."""
        return params.mlp(x)

    def apply_output_activation(self, x: torch.Tensor) -> torch.Tensor:
        return resolve_activation(self.output_activation)(x)

    def forward_with_intermediate_values(self, params: NeuralLinearParams, x: torch.Tensor):
        """(mu before the activation, sigma, learned features) for x (N, f)."""
        feats = self.features(params, x)
        linreg = self.linear_regression()
        L = linreg.factor(params.linreg)
        if self.nn_e2e:
            mu = params.head(feats)[..., 0]
        else:
            mu = linreg.predict(params.linreg, feats, L)
        return mu, linreg.calculate_sigma(params.linreg, feats, L), feats
