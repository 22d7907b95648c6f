"""Replay and exploration of the PyTorch port against the JAX package's:
`BasicReplayBuffer`'s bump-ring push and wrap-restart on given data, the
gather for given indices, and ε-greedy (with its linear schedule) on given
uniforms. The draws JAX makes from its key are computed with jax.random and
handed to the port, so no test relies on the two RNGs agreeing.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.policy_learners.exploration_modules.common import (
    EGreedyExploration as JaxEGreedy,
    StepCount,
    _uniform_index,
    masked_argmax as jax_masked_argmax,
)
from pearl_tpu.replay_buffers.replay_buffer import BasicReplayBuffer as JaxBuffer
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.policy_learners.exploration_modules import (
    EGreedyExploration,
    NoExploration,
    masked_argmax,
    uniform_index,
)
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch

torch.set_num_threads(1)

FIELDS = ("state", "action", "reward", "next_state", "terminated", "truncated", "action_index")


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        state=rng.standard_normal((n, 4)).astype(np.float32),
        action=rng.integers(0, 2, (n, 1)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_state=rng.standard_normal((n, 4)).astype(np.float32),
        terminated=rng.random(n) < 0.3,
        truncated=rng.random(n) < 0.1,
        action_index=rng.integers(0, 2, n).astype(np.int32),
    )


def _torch_batch(d):
    return TransitionBatch(**{k: torch.from_numpy(v) for k, v in d.items()})


def _jax_batch(d):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def test_push_wrap_restart_and_gather_match_jax():
    capacity, n = 10, 4  # the third push does not fit: it restarts at slot 0
    jbuf, tbuf = JaxBuffer(capacity=capacity), BasicReplayBuffer(capacity=capacity)
    example = _batch(1, 0)
    jstate = jbuf.init(_jax_batch(example))
    tstate = tbuf.init(_torch_batch(example))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn: 10 % 4 != 0
        for i in range(4):
            data = _batch(n, i + 1)
            jstate = jbuf.push(jstate, _jax_batch(data))
            tstate = tbuf.push(tstate, _torch_batch(data))
            assert tstate.cursor == int(jstate.cursor)
            assert tstate.size == int(jstate.size)
    assert (tstate.cursor, tstate.size) == (8, 8)  # pushes at 0, 4, 0 (restart), 4
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(tstate.storage, f).numpy(), np.asarray(getattr(jstate.storage, f))
        )
    idx = np.array([0, 7, 3, 3, 5], np.int64)
    got = tbuf.sample(tstate, None, 5, indices=torch.from_numpy(idx))
    for f in FIELDS:
        ref = np.asarray(getattr(jstate.storage, f))[idx]
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref)
    assert got.curr_available_mask is None and got.weight is None


def test_push_warns_on_misaligned_capacity_and_samples_written_rows():
    buf = BasicReplayBuffer(capacity=10)
    state = buf.init(_torch_batch(_batch(1, 0)))
    with pytest.warns(UserWarning, match="not a multiple"):
        state = buf.push(state, _torch_batch(_batch(3, 1)))
    idx = buf.sample_indices(state, torch.Generator().manual_seed(0), 1000)
    assert idx.min() >= 0 and idx.max() < 3  # never-written slots are never drawn
    assert buf.clear(state).size == 0


def test_masked_argmax_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 3, (64, 4)).astype(np.float32)  # many ties
    mask = rng.random((64, 4)) < 0.7
    mask[:, 2] = True
    for m in (None, mask):
        ours = masked_argmax(torch.from_numpy(scores), None if m is None else torch.from_numpy(m))
        ref = jax_masked_argmax(jnp.asarray(scores), None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "config,step",
    [
        (dict(epsilon=0.3), 0),
        (dict(start_epsilon=0.9, end_epsilon=0.05, warmup_steps=1000), 400),
        (dict(start_epsilon=0.9, end_epsilon=0.05, warmup_steps=1000), 5000),
    ],
)
def test_egreedy_on_given_uniforms_matches_jax(config, step, masked):
    B, A = 256, 3
    rng = np.random.default_rng(step)
    scores = rng.standard_normal((B, A)).astype(np.float32)
    mask = rng.random((B, A)) < 0.6 if masked else None
    if masked:
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(mask)
    exploit = jax_masked_argmax(jnp.asarray(scores), jmask)
    key = jax.random.PRNGKey(step + 1)
    # The draws JAX's act makes from this key (common.py:160-166).
    k_bernoulli, k_uniform = jax.random.split(key)
    u = np.array(jax.random.uniform(k_bernoulli, (B,)))
    ridx = np.array(_uniform_index(k_uniform, B, A, jmask))
    jstate, jindex = JaxEGreedy(**config).act(
        StepCount(step=jnp.int32(step)), jnp.asarray(scores), exploit, jmask, key
    )

    tstep, tindex = EGreedyExploration(**config).act(
        step,
        torch.from_numpy(scores),
        torch.from_numpy(np.array(exploit)),
        None if mask is None else torch.from_numpy(mask),
        None,
        draws=(torch.from_numpy(u), torch.from_numpy(ridx)),
    )
    np.testing.assert_array_equal(tindex.numpy(), np.asarray(jindex))
    assert tstep == int(jstate.step) == step + B
    eps = EGreedyExploration(**config).current_epsilon(step)
    np.testing.assert_allclose(eps, float(JaxEGreedy(**config).current_epsilon(jnp.int32(step))), rtol=1e-6)
    assert 0 < (tindex.numpy() != np.asarray(exploit)).sum()  # some rows explored


def test_uniform_index_picks_only_available_actions_uniformly():
    n = 30_000
    mask = torch.tensor([[True, False, True, True]]).expand(n, 4)
    noise = torch.rand((n, 4), generator=torch.Generator().manual_seed(0))
    idx = uniform_index(noise, mask)
    counts = torch.bincount(idx.long(), minlength=4).numpy() / n
    assert counts[1] == 0
    np.testing.assert_allclose(counts[[0, 2, 3]], 1 / 3, atol=0.02)
    # The argmax of the noise over the available actions.
    noise = torch.tensor([[0.1, 0.9, 0.2, 0.3], [0.8, 0.1, 0.2, 0.7]])
    np.testing.assert_array_equal(uniform_index(noise, mask[:2]).numpy(), [3, 0])
    np.testing.assert_array_equal(uniform_index(noise, None).numpy(), [1, 0])


def test_egreedy_draws_from_its_generator():
    B, A = 4096, 2
    scores = torch.zeros((B, A))
    exploit = torch.zeros(B, dtype=torch.int32)
    mask = torch.ones((B, A), dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    step, index = EGreedyExploration(epsilon=0.5).act(0, scores, exploit, mask, gen)
    assert step == B
    # Half the rows explore, half of those pick action 1.
    np.testing.assert_allclose(index.float().mean().item(), 0.25, atol=0.03)
    again = EGreedyExploration(epsilon=0.5).act(
        0, scores, exploit, mask, torch.Generator().manual_seed(0)
    )[1]
    torch.testing.assert_close(index, again, rtol=0, atol=0)


def test_no_exploration_is_greedy():
    idx = torch.tensor([1, 0, 2], dtype=torch.int32)
    assert NoExploration().act((), torch.zeros(3, 3), idx, None, None) == ((), idx)
