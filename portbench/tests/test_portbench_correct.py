"""The comparison that decides `correct`, driven on the CPU at 4 envs with
each cell's own limits: the port passes; the control (the reference one
precision below the configuration, in the program's place) fails, and so
does the reference in its place with each planted fault; and a run with the
timed path broken underneath fails, once for each fault the cells can have
(one chip: no exchange between chips to leave out)."""

import dataclasses
import time

import pytest
import torch

from portbench import control
from portbench.core import cell as cell_mod
from portbench.core import compare
from portbench.reference import dqn_pixel

from conftest import PIXEL_CELLS

SEED = 2**31 + 11


def run(cell, seed=SEED):
    names = {"end_to_end": ["env_steps_per_s", "setup_s"], "per_layer": []}
    return cell_mod.run(cell, seed, 0.5, False, "cpu", time.perf_counter(), names)


@pytest.mark.parametrize("name", PIXEL_CELLS)
def test_port_matches_reference_at_4_envs(tiny_cell, name):
    out = run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["metrics"]["env_steps_per_s"] > 0


STAND_INS = [(name, fault) for name in PIXEL_CELLS for fault in dqn_pixel.FAULTS
             if "collect" not in name or fault in ("none", "altered_action")]


@pytest.mark.parametrize("name,fault", STAND_INS)
def test_control_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name)
    values = control.control(cell, 7, "cpu", fault)
    assert not compare.verdict(values, cell.limits), values
    if fault == "wrap_range":
        assert values["wrap_loss_gap"] > cell.limits["wrap_loss_gap"], values


def _frozen_learn(self, state, batch):
    """A learn that returns its state unchanged."""
    return dataclasses.replace(state, step=state.step + 1), self.td_loss(state, batch)[1]


def _half_batch(td_loss):
    def loss(self, state, batch):
        n = batch.reward.shape[0] // 2
        half = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)})
        return td_loss(self, state, half)
    return loss


def _altered_act(act):
    def altered(self, state, subjective_state, mask, generator, exploit=False):
        state, choice = act(self, state, subjective_state, mask, generator, exploit)
        index = choice.index.clone()
        index[0] = (index[0] + 1) % mask.shape[-1]
        return state, dataclasses.replace(
            choice, index=index, action=state.action_elements[index.long()])
    return altered


def _altered_frame(obs):
    def altered(self, state):
        out = obs(self, state)
        out[0, 0] += 0.5
        return out
    return altered


def _wrap_range(sample_range):
    """After the ring wraps, draws that reach into the oldest pushes, whose
    windows have lost frames."""
    def wrapped(self, state):
        oldest, n = sample_range(self, state)
        if oldest == 0:
            return oldest, n
        return oldest - (self.stack - 1), n + (self.stack - 1) * self.num_envs
    return wrapped


FAULTS = {
    "unchanged_state": ("learn_batch", lambda orig: _frozen_learn),
    "wrap_range": ("_sample_range", _wrap_range),
    "half_batch": ("td_loss", _half_batch),
    "altered_action": ("act", _altered_act),
    "altered_frame": ("_obs", _altered_frame),
}


# The numbers that each fault must fail (at least one of them).
EXPECTED = {
    "unchanged_state": {"delta_gap", "grad_gap", "target_gap"},
    "half_batch": {"loss_gap", "grad_gap", "delta_gap"},
    "altered_action": {"act_gap", "explore_mismatch", "rows_mismatch"},
    "altered_frame": {"frame_gap", "frame_print_gap"},
    "wrap_range": {"wrap_loss_gap", "wrap_grad_gap"},
}
LEARN_FAULTS = ("unchanged_state", "half_batch", "wrap_range")
CASES = [(name, fault) for name in PIXEL_CELLS for fault in sorted(FAULTS)
         if "collect" not in name or fault not in LEARN_FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_path_is_not_correct(tiny_cell, monkeypatch, name, fault):
    from pearl_tpu_torch.envs.synthetic_visual import SyntheticAtari
    from pearl_tpu_torch.policy_learners.sequential_decision_making.deep_td import (
        DeepTDLearning,
    )
    from pearl_tpu_torch.replay_buffers import VisualReplayBuffer

    cell = tiny_cell(name)
    attr, make = FAULTS[fault]
    owner = {"_obs": SyntheticAtari, "_sample_range": VisualReplayBuffer}.get(attr, DeepTDLearning)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = run(cell)
    assert not out["correct"], out["checks"]
    failed = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    assert failed & EXPECTED[fault], out["checks"]
