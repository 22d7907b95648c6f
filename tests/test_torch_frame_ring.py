"""`FrameRingHistorySummarization` of the PyTorch port
(pearl_tpu_torch/history_summarization_modules/frame_ring.py) against the
JAX module (pearl_tpu/history_summarization_modules/frame_ring.py), against
a numpy stacking oracle and against the port's own
`StackingHistorySummarization(include_action=False)` advanced as the agent
advances it, over a scripted episode stream with resets:
the same numpy-made observations and done masks go through both. Frames are
only moved and masked, never computed on, so everything is compared exactly.
The port writes its ring in place; the aliasing that follows is pinned here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.history_summarization_modules.frame_ring import (
    FrameRingHistorySummarization as JaxFrameRing,
)
from pearl_tpu.history_summarization_modules.frame_ring import FrameRingView as JaxView
from pearl_tpu_torch.history_summarization_modules import (
    FrameRingHistorySummarization,
    FrameRingView,
    StackingHistorySummarization,
)
from pearl_tpu_torch.utils.pytree import tree_select

torch.set_num_threads(1)

DTYPES = [(None, None), (torch.bfloat16, jnp.bfloat16)]
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _same_view(tview: FrameRingView, jview: JaxView):
    assert tview.cursor == int(jview.cursor)
    np.testing.assert_array_equal(_np(tview.valid), _np(jview.valid))
    # Invalid slots may hold different stale frames only if a write differed;
    # both packages write the same frames, so the whole ring is equal.
    np.testing.assert_array_equal(_np(tview.ring), _np(jview.ring))
    np.testing.assert_array_equal(_np(tview.materialize()), _np(jview.materialize()))


class StackingOracle:
    """The window a stacking summarizer over observations holds: the last T
    observations of the current episode, zero-padded on the old side."""

    def __init__(self, B, T, F, first):
        self.T, self.F = T, F
        self.frames = [[first[b]] for b in range(B)]

    def advance(self, obs, reset_obs, done):
        for b, frames in enumerate(self.frames):
            if done[b]:
                frames[:] = [reset_obs[b]]
            else:
                frames.append(obs[b])

    def window(self):
        out = np.zeros((len(self.frames), self.T, self.F), np.float32)
        for b, frames in enumerate(self.frames):
            last = frames[-self.T:]
            out[b, self.T - len(last):] = np.stack(last)
        return out.reshape(len(self.frames), -1)


def _rounded(x, tdtype):
    """numpy float32 values as the ring dtype holds them."""
    return x if tdtype is None else torch.from_numpy(x).to(tdtype).to(torch.float32).numpy()


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("T", [1, 3, 4])
def test_scripted_episode_matches_jax_and_the_stacking_oracle(tdtype, jdtype, T):
    B, F, steps = 5, 12, 14
    rng = np.random.default_rng(T)
    jsumm = JaxFrameRing(history_length=T, dtype=jdtype)
    tsumm = FrameRingHistorySummarization(history_length=T, dtype=tdtype)
    first = rng.uniform(0, 255, (B, F)).astype(np.float32)
    jview = jsumm.observe(jsumm.init_carry(B, F, 0), jnp.asarray(first), None)
    tview = tsumm.observe(tsumm.init_carry(B, F, 0, CPU), torch.from_numpy(first), None)
    assert tview.ring.dtype == (tdtype or torch.float32)
    oracle = StackingOracle(B, T, F, _rounded(first, tdtype))
    stacking = StackingHistorySummarization(history_length=T, include_action=False)
    window = stacking.observe(
        stacking.init_carry(B, F, 0, CPU), torch.from_numpy(_rounded(first, tdtype)), None
    )
    _same_view(tview, jview)
    for step in range(steps):
        obs = rng.uniform(0, 255, (B, F)).astype(np.float32)
        reset_obs = rng.uniform(0, 255, (B, F)).astype(np.float32)
        done = rng.random(B) < 0.25
        if step == 5:
            done[:] = True  # every env at once, as a lockstep time limit does
        # The acting frame, read before the write.
        np.testing.assert_array_equal(
            _np(tsumm.newest_frame(tview)), _np(jsumm.newest_frame(jview))
        )
        jview = jsumm.advance(jview, jnp.asarray(obs), jnp.asarray(reset_obs), jnp.asarray(done))
        tview = tsumm.advance(
            tview, torch.from_numpy(obs), torch.from_numpy(reset_obs), torch.from_numpy(done)
        )
        oracle.advance(_rounded(obs, tdtype), _rounded(reset_obs, tdtype), done)
        # The agent's generic step: append, and where done restart the
        # window from the reset observation.
        after = stacking.observe(window, torch.from_numpy(_rounded(obs, tdtype)), None)
        fresh = stacking.observe(
            stacking.reset_envs(after, torch.from_numpy(done)),
            torch.from_numpy(_rounded(reset_obs, tdtype)), None,
        )
        window = tree_select(torch.from_numpy(done), fresh, after)
        _same_view(tview, jview)
        np.testing.assert_array_equal(_np(tview.materialize()), oracle.window())
        np.testing.assert_array_equal(_np(tview.materialize()), stacking.stored(window).numpy())
        np.testing.assert_array_equal(
            _np(tsumm.newest_frame(tview)), oracle.window()[:, -F:]
        )
    assert tsumm.stored(tview) is tview and tsumm.forward({}, tview) is tview
    assert tview.shape == (B, T * F) and tview.dtype == (tdtype or torch.float32)
    assert tsumm.subjective_dim(F, 3) == tsumm.stored_dim(F, 3) == T * F == jsumm.stored_dim(F, 3)
    assert tsumm.is_frame_ring


def test_observe_then_reset_envs_matches_jax():
    B, T, F = 4, 3, 6
    rng = np.random.default_rng(9)
    jsumm, tsumm = JaxFrameRing(history_length=T), FrameRingHistorySummarization(history_length=T)
    jview, tview = jsumm.init_carry(B, F, 0), tsumm.init_carry(B, F, 0, CPU)
    for step in range(5):
        obs = rng.uniform(0, 255, (B, F)).astype(np.float32)
        jview = jsumm.observe(jview, jnp.asarray(obs), None)
        tview = tsumm.observe(tview, torch.from_numpy(obs), None)
        _same_view(tview, jview)
        if step == 2:
            done = np.array([True, False, False, True])
            jview = jsumm.reset_envs(jview, jnp.asarray(done))
            tview = tsumm.reset_envs(tview, torch.from_numpy(done))
            _same_view(tview, jview)
            assert not tview.valid[0].any() and tview.valid[1].any()


def test_replay_windows_become_an_all_valid_ring_at_cursor_zero():
    B, T, F = 3, 4, 5
    stored = np.random.default_rng(1).uniform(0, 255, (B, T * F)).astype(np.float32)
    jview = JaxFrameRing(history_length=T).forward({}, jnp.asarray(stored))
    tview = FrameRingHistorySummarization(history_length=T).forward({}, torch.from_numpy(stored))
    assert tview.from_replay and jview.from_replay and tview.cache is None
    _same_view(tview, jview)
    np.testing.assert_array_equal(tview.materialize().numpy(), stored)
    cast = tview.astype(torch.bfloat16)
    assert cast.ring.dtype == torch.bfloat16 and cast.valid is tview.valid and cast.from_replay
    assert tview.astype(torch.float32).ring is tview.ring  # no copy when the dtype holds


def test_in_place_ring_and_what_it_means_for_the_caller():
    B, T, F = 2, 3, 4
    summ = FrameRingHistorySummarization(history_length=T)
    frames = [torch.full((B, F), float(i)) for i in range(1, 6)]
    done = torch.tensor([False, True])
    v0 = summ.init_carry(B, F, 0, CPU)
    v1 = summ.observe(v0, frames[0], None)
    # One storage: the view handed in sees the new frame, but keeps its own
    # cursor and mask.
    assert v1.ring.data_ptr() == v0.ring.data_ptr()
    assert v0.cursor == 0 and v1.cursor == 1 and not v0.valid.any() and v1.valid[:, 0].all()
    newest = summ.newest_frame(v1)
    assert newest.data_ptr() == v1.ring[:, 0].data_ptr() and not newest.is_contiguous()
    kept = newest.clone()
    v2 = summ.advance(v1, frames[1], frames[2], done)
    assert torch.equal(newest, kept)  # T > 1: another slot was written
    assert torch.equal(v2.ring[:, 1], torch.where(done[:, None], frames[2], frames[1]))
    assert v2.valid.tolist() == [[True, True, False], [False, True, False]]
    assert v1.valid.tolist() == [[True, False, False], [True, False, False]]  # not aliased

    # history_length == 1: the slot the acting frame lives in IS the slot
    # that advance writes, so it must be copied out first.
    one = FrameRingHistorySummarization(history_length=1)
    w1 = one.observe(one.init_carry(B, F, 0, CPU), frames[0], None)
    acting = one.newest_frame(w1)
    copy = acting.clone()
    w2 = one.advance(w1, frames[3], frames[4], done)
    assert w2.cursor == 0 and not torch.equal(acting, copy)
    assert torch.equal(acting, torch.where(done[:, None], frames[4], frames[3]))

    # tree_select between two states makes new storage for every leaf.
    a = summ.observe(summ.init_carry(B, F, 0, CPU), frames[0], None)
    b = summ.observe(summ.init_carry(B, F, 0, CPU), frames[1], None)
    picked = tree_select(done, a, b)
    assert picked.ring.data_ptr() not in (a.ring.data_ptr(), b.ring.data_ptr())
    assert torch.equal(picked.ring[0], b.ring[0]) and torch.equal(picked.ring[1], a.ring[1])
    assert picked.cursor == 1


def test_observe_casts_to_the_ring_dtype_and_checks_shapes():
    summ = FrameRingHistorySummarization(history_length=2, dtype=torch.bfloat16)
    view = summ.observe(summ.init_carry(3, 4, 0, CPU), torch.full((3, 4), 1.00390625), None)
    assert view.ring.dtype == torch.bfloat16 and (view.ring[:, 0] == 1.0).all()
    with pytest.raises(ValueError, match="shape"):
        summ.observe(view, torch.zeros((3, 5)), None)
    with pytest.raises(TypeError, match="bool"):
        summ.advance(view, torch.zeros((3, 4)), torch.zeros((3, 4)), torch.zeros(3))
