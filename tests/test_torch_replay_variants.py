"""The replay variants of the PyTorch port against the JAX package's:
bfloat16 storage and the one-row buffer, `PackedReplayBuffer` (its ring, its
round trips and its refusals), `PrioritizedReplayBuffer` (push, importance
weights for given indices, the write-back with repeated indices, the draw's
distribution, and a three-round DQN `learn` against optax on JAX's own
indices), the bootstrap mask, HER's push and flush across a ring wrap, the
sparse-reward env's transitions, and uint8 frames through the visual buffer.

The JAX draws are computed from the JAX code's own keys and handed to the
port's seams (`indices=`, `mask=`); no test relies on the two RNGs agreeing.
Moved and cast data is compared exactly; computed data at the tolerance
stated where it is used.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.envs.sparse_reward import (
    ContinuousSparseRewardEnvironment as JaxContinuousReach,
    DiscreteSparseRewardEnvironment as JaxReach,
    SparseRewardState as JaxReachState,
)
from pearl_tpu.neural_networks.q_value_networks import MultiHeadQValueNetwork as JaxMultiHead
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.bootstrap import BootstrapReplayBuffer as JaxBootstrap
from pearl_tpu.replay_buffers.hindsight import HindsightExperienceReplayBuffer as JaxHER
from pearl_tpu.replay_buffers.packed import PackedReplayBuffer as JaxPacked
from pearl_tpu.replay_buffers.prioritized import PrioritizedReplayBuffer as JaxPrioritized
from pearl_tpu.replay_buffers.replay_buffer import (
    BasicReplayBuffer as JaxBuffer,
    SingleTransitionReplayBuffer as JaxSingle,
)
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.replay_buffers.transition import single_transition as jax_single_transition
from pearl_tpu.replay_buffers.visual import VisualReplayBuffer as JaxVisual
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import (
    CartPole,
    ContinuousSparseRewardEnvironment,
    DiscreteSparseRewardEnvironment,
    SparseRewardState,
)
from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import (
    BasicReplayBuffer,
    BootstrapReplayBuffer,
    HindsightExperienceReplayBuffer,
    PackedReplayBuffer,
    PrioritizedReplayBuffer,
    SingleTransitionReplayBuffer,
    TransitionBatch,
    VisualReplayBuffer,
)
from pearl_tpu_torch.replay_buffers.prioritized import last_occurrence_values
from pearl_tpu_torch.replay_buffers.transition import single_transition
from pearl_tpu_torch.training import make_compiled_runner, online_learning
from pearl_tpu_torch.utils import make_generator
from pearl_tpu_torch.utils.jax_params import load_flax_q_params

from test_torch_dqn_family import STEP_TOL, _np_tree
from test_torch_visual_replay import B as VIS_B
from test_torch_visual_replay import CAP_PUSHES, _examples, _jax_draws, _rest, _same_batch, _stream

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _data(n, seed, state_dim=4, extra=()):
    """A batch of n transitions as numpy, with the optional fields in
    `extra` ("mask", "weight", "bootstrap_mask")."""
    rng = np.random.default_rng(seed)
    d = dict(
        state=rng.standard_normal((n, state_dim)).astype(np.float32),
        action=rng.integers(0, 2, (n, 1)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_state=rng.standard_normal((n, state_dim)).astype(np.float32),
        terminated=rng.random(n) < 0.3,
        truncated=rng.random(n) < 0.1,
        action_index=rng.integers(0, 2, n).astype(np.int32),
    )
    if "mask" in extra:
        d["curr_available_mask"] = rng.random((n, 3)) < 0.7
    if "weight" in extra:
        d["weight"] = rng.random(n).astype(np.float32)
    if "bootstrap_mask" in extra:
        d["bootstrap_mask"] = (rng.random((n, 5)) < 0.5).astype(np.float32)
    return d


def _tb(d):
    return TransitionBatch(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _jb(d):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _fields(batch):
    return [f.name for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None]


def _assert_batch_equal(got, want):
    assert _fields(got) == [f for f in _fields(want)]
    for f in _fields(want):
        g, w = getattr(got, f), getattr(want, f)
        assert tuple(g.shape) == tuple(w.shape), f
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), f
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f)


def _jax_uniform_indices(jstate, key, batch_size):
    """The rows `BasicReplayBuffer.sample` draws with `key`."""
    return np.asarray(jax.random.randint(key, (batch_size,), 0, max(int(jstate.size), 1)))


# ------------------------------------------------------------ bf16 storage


def test_bf16_storage_round_trips_like_jax():
    jbuf, tbuf = JaxBuffer(capacity=8, bf16_storage=True), BasicReplayBuffer(
        capacity=8, bf16_storage=True)
    example = _data(1, 0, extra=("weight",))
    jstate, tstate = jbuf.init(_jb(example)), tbuf.init(_tb(example))
    assert tstate.storage.state.dtype == torch.bfloat16
    assert tstate.storage.action_index.dtype == torch.int32
    assert tstate.storage.terminated.dtype == torch.bool
    for i in range(3):  # the third push wraps onto rows 0-3
        data = _data(4, i + 1, extra=("weight",))
        jstate, tstate = jbuf.push(jstate, _jb(data)), tbuf.push(tstate, _tb(data))
        assert (tstate.cursor, tstate.size) == (int(jstate.cursor), int(jstate.size))
    for f in _fields(tstate.storage):
        np.testing.assert_array_equal(
            _np(getattr(tstate.storage, f)), _np(getattr(jstate.storage, f)), err_msg=f
        )
    key = jax.random.PRNGKey(3)
    idx = _jax_uniform_indices(jstate, key, 16)
    got = tbuf.sample(tstate, None, 16, indices=torch.from_numpy(idx))
    want = jbuf.sample(jstate, key, 16)
    _assert_batch_equal(got, want)
    assert got.state.dtype == got.reward.dtype == got.weight.dtype == torch.float32
    # One bfloat16 rounding of the pushed float32 values (rows 0-3 hold the
    # third push, 4-7 the second): 8 bits of mantissa.
    pushed = np.concatenate([_data(4, 3, extra=("weight",))["state"],
                             _data(4, 2, extra=("weight",))["state"]])
    np.testing.assert_allclose(got.state.numpy(), pushed[idx], rtol=2**-8, atol=0)


def test_single_transition_buffer_holds_the_last_row():
    jbuf, tbuf = JaxSingle(), SingleTransitionReplayBuffer()
    assert tbuf.capacity == jbuf.capacity == 1
    assert not tbuf.supports_deferred_push and not jbuf.supports_deferred_push
    example = _data(1, 0)
    jstate, tstate = jbuf.init(_jb(example)), tbuf.init(_tb(example))
    for i in range(3):
        data = _data(1, i + 1)
        jstate, tstate = jbuf.push(jstate, _jb(data)), tbuf.push(tstate, _tb(data))
        assert (tstate.cursor, tstate.size) == (int(jstate.cursor), int(jstate.size)) == (0, 1)
    got = tbuf.sample(tstate, torch.Generator().manual_seed(0), 4)
    _assert_batch_equal(got, jbuf.sample(jstate, jax.random.PRNGKey(0), 4))


def test_single_transition_equals_jax():
    """Unbatched leaves (arrays, numbers, a tensor) gain a batch axis of 1,
    with JAX's default dtypes: float64 becomes float32, int64 int32."""
    rng = np.random.default_rng(3)
    leaves = dict(
        state=rng.standard_normal(4),  # float64
        action=np.array([1.0], np.float32),
        reward=0.5,
        next_state=rng.standard_normal(4).astype(np.float32),
        terminated=True,
        truncated=np.bool_(False),
        action_index=np.int64(1),
        curr_available_mask=np.array([True, False]),
        weight=None,
    )
    ours = single_transition(**{**leaves, "next_state": torch.from_numpy(leaves["next_state"])})
    ref = jax_single_transition(**leaves)
    assert ours.batch_size == 1 and ours.weight is None and ref.weight is None
    for field in dataclasses.fields(ref):
        r = getattr(ref, field.name)
        if r is None:
            assert getattr(ours, field.name) is None, field.name
            continue
        o = getattr(ours, field.name).numpy()
        assert o.shape == np.asarray(r).shape and o.dtype == np.asarray(r).dtype, field.name
        np.testing.assert_array_equal(o, np.asarray(r), err_msg=field.name)


# ------------------------------------------------------------------ packed

PACKED_EXTRA = ("mask", "weight", "bootstrap_mask")


def test_packed_ring_matches_jax_and_samples_like_basic():
    cap, n = 12, 4
    jbuf, tbuf, basic = JaxPacked(capacity=cap), PackedReplayBuffer(capacity=cap), \
        BasicReplayBuffer(capacity=cap)
    example = _data(1, 0, extra=PACKED_EXTRA)
    jstate, tstate, bstate = jbuf.init(_jb(example)), tbuf.init(_tb(example)), \
        basic.init(_tb(example))
    template = tstate.storage["template"]
    assert template.curr_available_mask.shape == (0, 3) and template.next_available_mask is None
    for i in range(5):  # a wrap: pushes at rows 0, 4, 8, 0, 4
        data = _data(n, i + 1, extra=PACKED_EXTRA)
        jstate = jbuf.push(jstate, _jb(data))
        tstate, bstate = tbuf.push(tstate, _tb(data)), basic.push(bstate, _tb(data))
        assert (tstate.cursor, tstate.size) == (int(jstate.cursor), int(jstate.size)) == \
            (bstate.cursor, bstate.size)
    # The same columns in the same order: bool and int32 as {0, 1} and exact floats.
    np.testing.assert_array_equal(tstate.storage["packed"].numpy(),
                                  np.asarray(jstate.storage["packed"]))
    key = jax.random.PRNGKey(7)
    idx = torch.from_numpy(_jax_uniform_indices(jstate, key, 32))
    got = tbuf.sample(tstate, None, 32, indices=idx)
    _assert_batch_equal(got, jbuf.sample(jstate, key, 32))
    _assert_batch_equal(got, basic.sample(bstate, None, 32, indices=idx))
    assert all(getattr(got, f).is_contiguous() for f in _fields(got))


def test_packed_round_trips_integers_exactly():
    buf = PackedReplayBuffer(capacity=4)
    data = _data(4, 0)
    data["action_index"] = np.array([0, 1, 2**24 - 1, -(2**24)], np.int32)
    data["terminated"] = np.array([True, False, True, False])
    state = buf.push(buf.init(_tb(data)), _tb(data))
    got = buf.sample(state, None, 4, indices=torch.arange(4))
    assert got.action_index.dtype == torch.int32 and got.terminated.dtype == torch.bool
    np.testing.assert_array_equal(got.action_index.numpy(), data["action_index"])
    np.testing.assert_array_equal(got.terminated.numpy(), data["terminated"])


@pytest.mark.parametrize("case", ["bf16_storage", "int64"])
def test_packed_refuses_what_float32_cannot_hold(case):
    data = _data(1, 0)
    jkw = kw = {}
    if case == "bf16_storage":
        jkw = kw = {"bf16_storage": True}
        match = "bf16_storage"
    else:
        data["action_index"] = data["action_index"].astype(np.int64)
        match = "int64"
    with pytest.raises(ValueError, match=match):
        PackedReplayBuffer(capacity=4, **kw).init(_tb(data))
    if case == "bf16_storage":  # JAX keeps int64 as int32 here, so only this case
        with pytest.raises(ValueError, match=match):
            JaxPacked(capacity=4, **jkw).init(_jb(data))


# ------------------------------------------------------------- prioritized


def _prioritized_pair(cap=16, **kw):
    jbuf, tbuf = JaxPrioritized(capacity=cap, **kw), PrioritizedReplayBuffer(capacity=cap, **kw)
    example = _data(1, 0)
    return jbuf, jbuf.init(_jb(example)), tbuf, tbuf.init(_tb(example))


def test_prioritized_push_weights_and_write_back_match_jax():
    jbuf, jstate, tbuf, tstate = _prioritized_pair(alpha=0.7, beta=0.5)
    jpush, jupdate = jax.jit(jbuf.push), jax.jit(jbuf.update_priorities)
    jsample = jax.jit(jbuf.sample_with_indices, static_argnums=2)
    rng = np.random.default_rng(4)
    for i in range(5):  # 12 rows a push: a restart at 0 on the second
        data = _data(6, i + 10)
        jstate, tstate = jpush(jstate, _jb(data)), tbuf.push(tstate, _tb(data))
        assert (tstate.cursor, tstate.size) == (int(jstate.cursor), int(jstate.size))
        np.testing.assert_array_equal(tstate.priorities.numpy(), np.asarray(jstate.priorities))
        # Write back at indices with repeats: the last occurrence wins in both.
        idx = rng.integers(0, int(jstate.size), 9)
        idx[-1] = idx[0]
        td = rng.standard_normal(9).astype(np.float32) * 3
        jstate = jupdate(jstate, jnp.asarray(idx), jnp.asarray(td))
        tstate = tbuf.update_priorities(tstate, torch.from_numpy(idx), torch.from_numpy(td))
        np.testing.assert_array_equal(tstate.priorities.numpy(), np.asarray(jstate.priorities))
        # The push after a write-back starts at max(max p, 1).
        key = jax.random.PRNGKey(i)
        jbatch, jidx = jsample(jstate, key, 20)
        got = tbuf.sample(tstate, None, 20, indices=torch.from_numpy(np.asarray(jidx)))
        for f in ("state", "reward", "action_index", "terminated"):
            np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(jbatch, f)))
        # Float64 weights against JAX's float32 softmax.
        np.testing.assert_allclose(got.weight.numpy(), np.asarray(jbatch.weight), rtol=2e-6)
        assert got.weight.dtype == torch.float32


def test_prioritized_draw_with_indices_equals_draw_then_gather():
    """`sample_with_indices` (one pass of the weights a draw, as the learner
    uses it) gives the indices of `sample_indices` on the same stream and the
    batch and importance weights that `sample(indices=)` gives for them."""
    _, _, tbuf, tstate = _prioritized_pair(cap=64, alpha=0.7, beta=0.5)
    tstate = tbuf.push(tstate, _tb(_data(40, 3)))
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 40, 30))
    tstate = tbuf.update_priorities(tstate, idx, torch.linspace(-4.0, 4.0, 30))
    got, got_idx = tbuf.sample_with_indices(tstate, torch.Generator().manual_seed(5), 32)
    want_idx = tbuf.sample_indices(tstate, torch.Generator().manual_seed(5), 32)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx.numpy())
    want = tbuf.sample(tstate, None, 32, indices=want_idx)
    for f in ("state", "reward", "action_index", "terminated"):
        np.testing.assert_array_equal(_np(getattr(got, f)), _np(getattr(want, f)))
    # The sum of all weights is the prefix sum's last, not a separate sum.
    np.testing.assert_allclose(got.weight.numpy(), want.weight.numpy(), rtol=1e-6)
    assert len(set(got_idx.tolist())) > 5


def test_last_occurrence_rule_equals_numpy_assignment():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 64, 1024):
        idx = rng.integers(0, max(n // 3, 1), n)
        values = rng.standard_normal(n).astype(np.float32)
        want = np.zeros(max(n // 3, 1), np.float32)
        want[idx] = values  # numpy: the last write to a position wins
        got = torch.zeros(len(want))
        got[torch.from_numpy(idx)] = last_occurrence_values(
            torch.from_numpy(idx), torch.from_numpy(values))
        np.testing.assert_array_equal(got.numpy(), want)


def test_prioritized_draws_follow_the_target_distribution():
    """Inverse-CDF draws over a fixed priority vector (7 rows written of 14;
    the others must never be drawn): Pearson's chi-square over the 7 written
    rows (6 degrees of freedom) below 22.46, its 0.001 critical value."""
    buf = PrioritizedReplayBuffer(capacity=14, alpha=0.6)
    state = buf.init(_tb(_data(1, 0)))
    state = buf.push(state, _tb(_data(7, 1)))
    p = torch.tensor([0.01, 0.5, 1.0, 2.0, 4.0, 8.0, 1e-6])
    state.priorities[:7].copy_(p)
    draws = 200_000
    idx = buf.sample_indices(state, torch.Generator().manual_seed(0), draws)
    counts = np.bincount(idx.numpy(), minlength=14)
    assert counts[7:].sum() == 0
    w = np.maximum(p.numpy().astype(np.float64), 1e-4) ** 0.6
    expected = draws * w / w.sum()
    chi2 = float(((counts[:7] - expected) ** 2 / expected).sum())
    assert chi2 < 22.46, (chi2, counts, expected)
    # The JAX sampler's distribution: softmax of its logits over the same rows.
    jlogits = 0.6 * np.log(np.maximum(p.numpy(), 1e-4))
    np.testing.assert_allclose(w / w.sum(), np.exp(jlogits) / np.exp(jlogits).sum(), rtol=1e-5)


def test_dqn_learn_with_prioritized_replay_matches_optax():
    """Three rounds of one `learn` on JAX's own indices: the sampled rows,
    the weighted TD loss, the AdamW steps and the priorities written back."""
    rounds, bs = 3, 32
    jl = JaxDQN(q_network=JaxMultiHead(hidden_dims=(16, 16)), training_rounds=rounds,
                batch_size=bs, target_update_freq=2)
    tl = DeepQLearning(q_network=MultiHeadQValueNetwork(hidden_dims=(16, 16)),
                       training_rounds=rounds, batch_size=bs, target_update_freq=2)
    from pearl_tpu.envs import CartPole as JaxCartPole

    jl, tl = jl.bind(JaxCartPole().action_space), tl.bind(CartPole().action_space)
    jls = jax.jit(lambda k: jl.init(k, 4, jl.action_space, 1))(jax.random.PRNGKey(0))
    tls = tl.init(torch.Generator().manual_seed(0), 4, tl.action_space, 1, CPU)
    weights = _np_tree(jls.params)
    load_flax_q_params(tls.params, weights)
    load_flax_q_params(tls.target_params, weights)
    jbuf, jbs, tbuf, tbs = _prioritized_pair(cap=64)
    for i in range(3):
        data = _data(16, i + 20)
        jbs, tbs = jbuf.push(jbs, _jb(data)), tbuf.push(tbs, _tb(data))
    # JAX's learn, and the indices it draws: its own keys, round by round.
    key = jax.random.PRNGKey(11)
    jls2, jbs2, jmetrics = jax.jit(lambda ls, b, k: jl.learn(ls, jbuf, b, k))(jls, jbs, key)

    @jax.jit
    def round_fn(ls, b, k):
        batch, idx = jbuf.sample_with_indices(b, k, bs)
        ls, m = jl.learn_batch(ls, batch)
        return ls, jbuf.update_priorities(b, idx, m["per_sample_td"]), idx

    indices, probe, probe_ls = [], jbs, jls
    for k in jax.random.split(key, rounds):
        probe_ls, probe, idx = round_fn(probe_ls, probe, k)
        indices.append(np.asarray(idx))
    # The same rounds as JAX's scan (which fuses the last float32 bit otherwise).
    np.testing.assert_allclose(np.asarray(probe.priorities), np.asarray(jbs2.priorities),
                               rtol=1e-6)
    tls2, tbs2, tmetrics = tl.learn(tls, tbuf, tbs, None,
                                    indices=torch.from_numpy(np.stack(indices)))
    assert tbs2 is tbs
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), **STEP_TOL)
    np.testing.assert_allclose(tbs2.priorities.numpy(), np.asarray(jbs2.priorities), **STEP_TOL)
    written = np.unique(np.concatenate(indices))
    assert (tbs2.priorities.numpy()[written] != 1.0).all()
    for ours, ref in ((tls2.params, jls2.params), (tls2.target_params, jls2.target_params)):
        for name, layer in zip(ours.MLP_0.layer_names, ours.MLP_0.layers()):
            r = _np_tree(ref)["MLP_0"][name]
            np.testing.assert_allclose(layer.weight.detach().numpy().T, r["kernel"], **STEP_TOL)
            np.testing.assert_allclose(layer.bias.detach().numpy(), r["bias"], **STEP_TOL)


# --------------------------------------------------------------- bootstrap


def test_bootstrap_mask_push_matches_jax():
    jbuf, tbuf = JaxBootstrap(capacity=16, ensemble_size=5, p=0.3), BootstrapReplayBuffer(
        capacity=16, ensemble_size=5, p=0.3)
    extra = tbuf.extra_example_fields(None, CPU)
    assert extra["bootstrap_mask"].shape == (1, 5)
    example = _data(1, 0) | {"bootstrap_mask": np.zeros((1, 5), np.float32)}
    jstate, tstate = jbuf.init(_jb(example)), tbuf.init(_tb(example))
    for i in range(3):
        data, key = _data(8, i + 1), jax.random.PRNGKey(i)
        jstate = jbuf.push(jstate, _jb(data), key)
        mask = np.asarray(jax.random.bernoulli(key, 0.3, (8, 5))).astype(np.float32)
        tstate = tbuf.push(tstate, _tb(data), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(tstate.storage.bootstrap_mask.numpy(),
                                  np.asarray(jstate.storage.bootstrap_mask))
    # The port's own draw: Bernoulli(p) per member, from the step's generator.
    big = BootstrapReplayBuffer(capacity=20_000, ensemble_size=5, p=0.3)
    state = big.push(big.init(_tb(example)), _tb(_data(20_000, 9)),
                     torch.Generator().manual_seed(0))
    mask = state.storage.bootstrap_mask
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    # 100000 Bernoulli(0.3) draws: the mean within 5 standard deviations (0.0072).
    assert abs(mask.mean().item() - 0.3) < 0.0072


# --------------------------------------------------------- sparse reward


@pytest.mark.parametrize("continuous", [False, True])
def test_sparse_reward_transitions_match_jax(continuous):
    kw = dict(length=50.0, num_actions=8, step_size=4.0, reward_distance=4.0, max_steps=5)
    jenv = (JaxContinuousReach if continuous else JaxReach)(**kw)
    env = (ContinuousSparseRewardEnvironment if continuous else DiscreteSparseRewardEnvironment)(
        **kw)
    rng = np.random.default_rng(1)
    B = 24
    position = rng.uniform(0, 50, (B, 2)).astype(np.float32)
    position[:4] = [[0.5, 0.5], [49.5, 49.5], [10.0, 10.0], [30.0, 1.0]]  # clipped moves
    goal = position + rng.uniform(-8, 8, (B, 2)).astype(np.float32)
    goal[:4] = position[:4] + [[1.0, 1.0], [-20.0, 0.0], [2.0, 0.5], [0.0, 30.0]]
    t = rng.integers(0, 5, B).astype(np.int32)
    if continuous:
        actions = rng.uniform(-6, 6, (B, 2)).astype(np.float32)
    else:
        actions = rng.integers(0, 8, (B, 1)).astype(np.float32)
    state, result = env.step(
        SparseRewardState(position=torch.from_numpy(position), goal=torch.from_numpy(goal),
                          t=torch.from_numpy(t)), torch.from_numpy(actions))
    for i in range(B):
        js, jr = jenv.step(JaxReachState(position=jnp.asarray(position[i]),
                                         goal=jnp.asarray(goal[i]), t=jnp.asarray(t[i])),
                           jnp.asarray(actions[i]), None)
        np.testing.assert_allclose(state.position[i].numpy(), np.asarray(js.position),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(result.observation[i].numpy(), np.asarray(jr.observation),
                                   rtol=1e-6, atol=1e-5)
        assert result.reward[i].item() == float(jr.reward)
        assert bool(result.terminated[i]) == bool(jr.terminated)
        assert bool(result.truncated[i]) == bool(jr.truncated)
        assert int(state.t[i]) == int(js.t)
    assert result.terminated.any() and result.truncated.any() and not (
        result.terminated & result.truncated).any()
    assert env.observation_dim == jenv.observation_dim == 4
    assert env.action_space.action_dim == jenv.action_space.action_dim
    _, obs = env.reset(B, torch.Generator().manual_seed(0), CPU)
    assert obs.shape == (B, 4) and ((obs >= 0) & (obs < 50)).all()


# --------------------------------------------------------------------- HER


def _her_stream(B, steps, seed=0):
    """Sparse-reach-like steps of B envs: several envs done at some steps,
    one episode longer than the cache (it keeps its last slot)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        d = _data(B, seed * 100 + s)
        done = np.zeros(B, bool)
        done[(s + np.arange(B)) % 3 == 0] = True  # a third of the envs each step
        done[0] = s in (6, 7)  # env 0 runs past max_episode_len before its end
        d["terminated"] = done & (rng.random(B) < 0.5)
        d["truncated"] = done & ~d["terminated"]
        out.append(d)
    return out


def test_her_push_and_flush_match_jax_across_a_wrap():
    B, L, cap = 4, 3, 20
    kw = dict(capacity=cap, num_envs=B, max_episode_len=L, goal_dim=2)
    jbuf, tbuf = JaxHER(**kw), HindsightExperienceReplayBuffer(**kw)
    jpush = jax.jit(jbuf.push)
    assert not tbuf.supports_deferred_push
    example = _data(1, 0)
    jstate, tstate = jbuf.init(_jb(example)), tbuf.init(_tb(example))
    wrapped = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 20 % 4 == 0: no warning is due, none expected
        for i, d in enumerate(_her_stream(B, 10)):
            before = int(jstate.cursor)
            jstate, tstate = jpush(jstate, _jb(d)), tbuf.push(tstate, _tb(d))
            assert tstate.cursor.item() == int(jstate.cursor), i
            assert tstate.size.item() == int(jstate.size), i
            wrapped = wrapped or int(jstate.cursor) < before
            np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jstate.lengths))
            for f in _fields(tstate.storage):
                np.testing.assert_array_equal(
                    getattr(tstate.storage, f)[:cap].numpy(),
                    np.asarray(getattr(jstate.storage, f)), err_msg=f"{f} after push {i}")
                np.testing.assert_array_equal(
                    getattr(tstate.trajectory, f).numpy(),
                    np.asarray(getattr(jstate.trajectory, f)), err_msg=f)
    assert wrapped and tstate.cursor.dtype == torch.int64
    # Relabeled rows: the goal swapped for the achieved position, reward 0 there.
    key = jax.random.PRNGKey(5)
    idx = torch.from_numpy(_jax_uniform_indices(jstate, key, 64))
    _assert_batch_equal(tbuf.sample(tstate, None, 64, indices=idx), jbuf.sample(jstate, key, 64))
    drawn = tbuf.sample_indices(tstate, torch.Generator().manual_seed(0), 4096)
    assert drawn.min() >= 0 and drawn.max() < tstate.size.item()
    assert len(drawn.unique()) == tstate.size.item()


def test_her_agent_learns_the_sparse_reach_at_a_tiny_size():
    """The driver with HER on the CPU: rows flushed beyond the raw pushes,
    relabeled rows with reward 0 whose next state sits on its goal."""
    env = DiscreteSparseRewardEnvironment(max_steps=10, length=20.0, step_size=4.0)
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
        replay_buffer=HindsightExperienceReplayBuffer(capacity=4096, num_envs=4,
                                                      max_episode_len=10, goal_dim=2),
    )
    res = online_learning(agent, env, num_envs=4, max_steps=256, learn_every_k_steps=8,
                          learning_starts=64, seed=0, device="cpu")
    replay = res.agent_state.replay
    size = replay.size.item()
    assert size > 256
    rewards = replay.storage.reward[:size]
    ns = replay.storage.next_state[:size]
    assert (rewards == 0).sum() > 0
    assert (torch.linalg.vector_norm(ns[:, :2] - ns[:, 2:], dim=-1) < 4.0).sum() > 0


# -------------------------------------------------------- the runners, CPU


@pytest.mark.parametrize("buffer", ["packed", "prioritized"])
def test_runner_with_packed_and_prioritized_replay_on_cpu(buffer):
    """The headline runner's composition at a tiny size: the same env
    steps as the basic buffer, and, for prioritized replay, priorities
    written back every learn."""
    make = {"packed": PackedReplayBuffer, "prioritized": PrioritizedReplayBuffer}[buffer]
    out = {}
    for name, cls in (("basic", BasicReplayBuffer), (buffer, make)):
        agent = PearlAgent(policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=1, batch_size=32),
            replay_buffer=cls(capacity=512))
        init_fn, run_fn = make_compiled_runner(agent, CartPole(), num_envs=16, steps_per_learn=4,
                                               learns_per_call=4, device="cpu")
        astate, env_states = init_fn(0)
        astate, env_states, stats = run_fn(astate, env_states, make_generator(0, "cpu"))
        out[name] = (astate, stats)
    basic, other = out["basic"][0].replay, out[buffer][0].replay
    assert (basic.cursor, basic.size) == (other.cursor, other.size) == (256, 256)
    assert out[buffer][1]["reward_sum"].item() == 256
    if buffer == "prioritized":
        p = other.priorities[:other.size]
        assert (p != 1.0).any() and torch.isfinite(p).all() and (p > 0).all()


# ----------------------------------------------------------- uint8 frames


def test_uint8_frames_round_trip_through_the_visual_buffer():
    """Frames that are integers in [0, 255] stored as uint8 in both packages:
    the ring holds them exactly, and both rebuild the same float32 stacks
    for JAX's draws."""
    kw = dict(capacity=CAP_PUSHES * VIS_B, stack=3, num_envs=VIS_B)
    jbuf = JaxVisual(frame_dtype=jnp.uint8, **kw)
    tbuf = VisualReplayBuffer(frame_dtype=torch.uint8, **kw)
    jpush, jsample = jax.jit(jbuf.push_frames), jax.jit(jbuf.sample, static_argnums=2)
    jex, tex = _examples()
    jstate, tstate = jbuf.init(jex), tbuf.init(tex)
    assert tstate.storage["frame_s"].dtype == torch.uint8
    for i, p in enumerate(_stream(9, seed=3)):
        fs, fn = np.floor(p["frame_s"]), np.floor(p["frame_n"])
        jstate = jpush(jstate, jnp.asarray(fs), jnp.asarray(fn), _rest(p, jnp))
        tstate = tbuf.push_frames(tstate, torch.from_numpy(fs), torch.from_numpy(fn),
                                  _rest(p, torch))
        np.testing.assert_array_equal(tstate.storage["frame_s"].numpy(),
                                      np.asarray(jstate.storage["frame_s"]))
        np.testing.assert_array_equal(tstate.storage["frame_s"].numpy()[
            (i % CAP_PUSHES) * VIS_B:(i % CAP_PUSHES + 1) * VIS_B], fs.astype(np.uint8))
        key = jax.random.PRNGKey(i)
        q, _ = _jax_draws(jbuf, jstate, key, 48)
        _same_batch(tbuf.sample(tstate, None, 48, indices=torch.from_numpy(q)),
                    jsample(jstate, key, 48))
