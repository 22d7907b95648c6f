"""Ensemble parallelism for BootstrappedDQN (port of
`pearl_tpu/parallel/ensemble_parallel.py`).

The K members of `EnsembleQValueNetwork` are independent until the loss's
final sum over members, so they shard over a `model` axis of a 2-D (data,
model) mesh: model rank j holds members [j K / M, (j + 1) K / M) of the
parameters, the target copy, the frozen priors and AdamW's moments (AdamW is
elementwise, so each member's step is its own). The batch shards over
`data`. The reference states this with sharding annotations and lets GSPMD
insert the collectives; here they are written out, and the result is the
unsharded `learn_batch`'s:

- each member's loss is normalised by max(sum of its mask, 1) over the
  GLOBAL batch (an all-reduce over `data` of the mask sums), and the data
  ranks' partial gradients are then SUMMED over `data`, not averaged from
  shard-local means;
- the `loss` metric is the mean |TD| over every row and member, and
  `per_sample_td` each row's mean over members: sums over `model` (and, for
  `loss`, over `data`), divided by the global counts;
- a summarizer with parameters is shared by every member: its gradient is
  summed over both axes.

`split_ensemble_state` cuts a full learner state into the M member slices
(this rank takes `slices[model_rank]`); `gather_ensemble_state` joins the
slices back into a full state.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Sequence, Tuple

import torch
from torch import nn

from pearl_tpu_torch.agent.pearl_agent import PearlAgent
from pearl_tpu_torch.parallel.data_parallel import Mesh, _axis, _group, _setup
from pearl_tpu_torch.utils.collectives import MeshAxis, psum
from pearl_tpu_torch.utils.pytree import soft_update


def make_2d_mesh(
    data: int, model: int, *, axis_names: Tuple[str, str] = ("data", "model"),
    device=None, backend=None,
) -> Mesh:
    """A (data, model) mesh of the world's first data * model ranks: rank r
    sits at (r // model, r % model). Two groups a rank: the ranks of its
    model index (its `data` axis) and those of its data index (its `model`
    axis). Every rank of the world calls it with the same arguments."""
    n = data * model
    device, backend, world, made = _setup(n, device, backend)
    d_name, m_name = axis_names
    axes = {d_name: None, m_name: None}
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        axes[d_name] = axes[d_name] or _axis(d_name, ranks, _group(ranks, world, backend), device)
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        axes[m_name] = axes[m_name] or _axis(m_name, ranks, _group(ranks, world, backend), device)
    return Mesh(axes=axes, shape={d_name: data, m_name: model}, device=device, backend=backend,
                world=made)


def _slice_learner(learner, members: int):
    return dataclasses.replace(
        learner, q_network=dataclasses.replace(learner.q_network, ensemble_size=members)
    )


def _params(module) -> List[nn.Parameter]:
    return list(module.parameters()) if isinstance(module, nn.Module) else []


def _remade(module: nn.Module, pieces, members: int) -> nn.Module:
    """A copy of the stacked `module` whose parameters are `pieces` (one
    tensor a parameter, leading axis the members) and whose member count is
    `members`."""
    out = copy.deepcopy(module)
    for (name, p), piece in zip(list(out.named_parameters()), pieces):
        owner_name, _, leaf = name.rpartition(".")
        owner = out.get_submodule(owner_name) if owner_name else out
        setattr(owner, leaf, nn.Parameter(piece.detach().clone(), requires_grad=p.requires_grad))
    for m in out.modules():
        if hasattr(m, "members"):
            m.members = members
    return out


def _sliced(module, lo: int, hi: int, members: int):
    if module is None:
        return None
    return _remade(module, [p[lo:hi] for p in module.parameters()], members)


def _joined(modules: Sequence, members: int):
    if modules[0] is None:
        return None
    pieces = zip(*(m.parameters() for m in modules))
    return _remade(modules[0], [torch.cat(ps) for ps in pieces], members)


def _optimizer_for(learner, state, moments):
    """`learner`'s optimizer over `state`'s Q-network and summarizer, its
    per-parameter state set to `moments` (one dict a parameter, or None)."""
    opt = learner.optimizer(state.params, state.summarizer_params)
    for p, m in zip(_params(state.params) + _params(state.summarizer_params), moments):
        if m is not None:
            opt.state[p] = m
    return opt


def _moments(state) -> list:
    opt = state.optimizer
    return [opt.state.get(p) for p in _params(state.params) + _params(state.summarizer_params)]


def split_ensemble_state(learner, state, model: int) -> list:
    """The `model` member slices of a full BootstrappedDQN learner state, in
    model-rank order. Summarizer parameters and everything per env are
    copied whole into every slice."""
    K = learner.q_network.ensemble_size
    _check_divides(K, model, "model")
    k = K // model
    n_q = len(_params(state.params))
    out = []
    for j in range(model):
        lo, hi = j * k, (j + 1) * k
        piece = dataclasses.replace(
            copy.deepcopy(state),
            params=_sliced(state.params, lo, hi, k),
            target_params=_sliced(state.target_params, lo, hi, k),
            prior_params=_sliced(state.prior_params, lo, hi, k),
            act_params=_sliced(state.act_params, lo, hi, k),
            act_prior_params=_sliced(state.act_prior_params, lo, hi, k),
        )
        moments = [
            None if m is None else {
                key: (v[lo:hi].clone() if i < n_q and v.dim() > 0 else v.clone())
                for key, v in m.items()
            }
            for i, m in enumerate(_moments(state))
        ]
        out.append(dataclasses.replace(
            piece, optimizer=_optimizer_for(_slice_learner(learner, k), piece, moments)
        ))
    return out


def gather_ensemble_state(learner, slices: Sequence):
    """The full learner state of `slices` (from `split_ensemble_state` or
    the model ranks' sharded learns, in model-rank order)."""
    K = learner.q_network.ensemble_size
    n_q = len(_params(slices[0].params))
    full = dataclasses.replace(
        copy.deepcopy(slices[0]),
        params=_joined([s.params for s in slices], K),
        target_params=_joined([s.target_params for s in slices], K),
        prior_params=_joined([s.prior_params for s in slices], K),
        act_params=_joined([s.act_params for s in slices], K),
        act_prior_params=_joined([s.act_prior_params for s in slices], K),
    )
    moments = []
    for i, per_slice in enumerate(zip(*(_moments(s) for s in slices))):
        if per_slice[0] is None:
            moments.append(None)
            continue
        moments.append({
            key: (torch.cat([m[key] for m in per_slice]) if i < n_q and v.dim() > 0
                  else v.clone())
            for key, v in per_slice[0].items()
        })
    return dataclasses.replace(full, optimizer=_optimizer_for(learner, full, moments))


def _check_divides(K: int, model: int, model_axis: str) -> None:
    if K % model != 0:
        raise ValueError(
            f"ensemble_size={K} must divide over the '{model_axis}' axis ({model} devices)"
        )


def make_ensemble_sharded_learn_batch(
    agent: PearlAgent, mesh: Mesh, *, data_axis: str = "data", model_axis: str = "model",
):
    """`(slice_state, batch_rows) -> (slice_state, metrics)`: one learn step
    of this rank's member slice (`split_ensemble_state(...)[model_rank]`) on
    this rank's rows of the batch (rows [i B / D, (i + 1) B / D) on data
    rank i); the bootstrap mask comes whole and is cut here. The metrics
    are the unsharded learn's, on every rank (`per_sample_td` for this
    rank's rows)."""
    learner = agent.policy_learner
    K = learner.q_network.ensemble_size
    M = mesh.shape[model_axis]
    _check_divides(K, M, model_axis)
    dax, max_ = mesh.axis(data_axis), mesh.axis(model_axis)
    k = K // M
    local = _slice_learner(learner, k)
    lo = max_.rank * k

    def reduce(tensors: list, axes: Sequence[MeshAxis]) -> list:
        for ax in axes:
            if ax.size > 1:
                tensors = psum(tensors, ax)
        return tensors

    def learn_batch(state, batch):
        if batch.bootstrap_mask is not None:
            batch = dataclasses.replace(batch, bootstrap_mask=batch.bootstrap_mask[:, lo:lo + k])
        td, mask = local.member_td(state, batch)
        (count,) = reduce([mask.sum(dim=0)], [dax])
        loss = ((td**2).sum(dim=0) / torch.clamp(count, min=1.0)).sum()
        q_params, summ_params = _params(state.params), _params(state.summarizer_params)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = reduce([p.grad for p in q_params], [dax])
        summ_grads = reduce([p.grad for p in summ_params if p.grad is not None], [dax, max_])
        for p, g in zip(q_params, grads):
            p.grad = g
        for p, g in zip([p for p in summ_params if p.grad is not None], summ_grads):
            p.grad = g
        state.optimizer.step()
        step = state.step + 1
        if step % local.target_update_freq == 0:
            soft_update(state.target_params, state.params, local.soft_update_tau)
        abs_td = td.detach().abs()
        rows = torch.full((), float(abs_td.shape[0]), device=abs_td.device)
        total, n_rows = reduce([abs_td.sum(), rows], [dax])
        total, per_row = reduce([total, abs_td.sum(dim=1)], [max_])
        metrics = {"loss": total / (n_rows * K), "per_sample_td": per_row / K}
        return dataclasses.replace(state, step=step), metrics

    return learn_batch
