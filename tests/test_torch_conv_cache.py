"""The conv1-cache act path of the PyTorch port against the JAX package on the
CPU: `ops/conv_cache.py` (`cache_write`, whose plain version runs here, and
`gather_sum`) against `pearl_tpu/ops/conv_cache.py`, the network's cache
functions against the JAX network on carried weights, and the agent's cache
lifecycle (seed at init, one write per observe, refresh after learn) through
resets and learns. Small frames (12 x 12 and 20 x 20), inputs from numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pearl_tpu.ops.conv_cache as jcc
from pearl_tpu.agent import PearlAgent as JaxAgent
from pearl_tpu.api.types import ActionResult as JaxActionResult
from pearl_tpu.envs.synthetic_visual import SyntheticAtari as JaxSyntheticAtari
from pearl_tpu.history_summarization_modules import FrameRingHistorySummarization as JaxFrameRing
from pearl_tpu.history_summarization_modules.frame_ring import FrameRingView as JaxView
from pearl_tpu.neural_networks.q_value_networks import CNNQValueNetwork as JaxCNN
from pearl_tpu.policy_learners.sequential_decision_making import DeepQLearning as JaxDQN
from pearl_tpu.replay_buffers.visual import VisualReplayBuffer as JaxVisual
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.api.types import ActionResult
from pearl_tpu_torch.envs import SyntheticAtari
from pearl_tpu_torch.history_summarization_modules import (
    FrameRingHistorySummarization,
    FrameRingView,
)
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.ops import conv_cache as tcc
from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import VisualReplayBuffer
from pearl_tpu_torch.utils.jax_params import (
    conv1_cache_from_numpy,
    frame_ring_view_from_numpy,
    load_flax_cnn_q_params,
)

torch.set_num_threads(1)

# float32 convolutions whose taps are summed in other orders.
TOL = dict(rtol=1e-5, atol=1e-5)
A = 5


def _np32(x):
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


@pytest.mark.parametrize("cursor", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_write_is_bit_equal_to_the_jax_cache_write(cursor, dtype):
    # A copy: the written chunks and the untouched entries are the same bits,
    # once the JAX cache (T, P, D, B), D in (OH, OW, OC) order, is carried
    # into the port's (T, P, B, D) with D in (OC, OH, OW) order.
    B, T, OC, OH, OW = 5, 4, 3, 4, 5
    D = OC * OH * OW
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(10 + cursor)
    # Values that both dtypes hold exactly.
    cache = torch.from_numpy(rng.normal(0, 1, (T, T, D, B)).astype(np.float32)).to(tdtype)
    y = torch.from_numpy(rng.normal(0, 1, (B, OH, OW, T * OC)).astype(np.float32)).to(tdtype)
    cache_np, y_np = cache.float().numpy(), y.float().numpy()

    want = jcc.cache_write(
        jnp.asarray(cache_np).astype(jdtype), jnp.asarray(y_np).astype(jdtype),
        jnp.int32(cursor), T=T, OC=OC,
    )
    assert want.dtype == jdtype
    tcache = conv1_cache_from_numpy(cache_np, (OH, OW, OC)).to(tdtype)
    before = tcache.clone()
    ty = torch.from_numpy(y_np.transpose(0, 3, 1, 2).copy()).to(tdtype)  # NCHW
    got = tcc.cache_write(tcache, ty, cursor, T=T, OC=OC)
    assert got is tcache and got.dtype == tdtype  # in place
    moved = conv1_cache_from_numpy(_np32(want), (OH, OW, OC))
    assert torch.equal(got.float(), moved)
    # Exactly the T diagonal entries changed: row (cursor - p) % T of position p.
    changed = (got != before).flatten(2).any(-1)
    expect = torch.zeros((T, T), dtype=torch.bool)
    for p in range(T):
        expect[(cursor - p) % T, p] = True
    assert torch.equal(changed, expect)


def test_cache_write_takes_a_channel_slice_and_casts_to_the_cache_dtype():
    B, T, OC, OH, OW = 3, 2, 2, 3, 3
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.normal(0, 1, (B, T * OC + 2, OH, OW)).astype(np.float32))
    y = wide[:, 1 : 1 + T * OC]
    cache = torch.zeros((T, T, B, OC * OH * OW), dtype=torch.bfloat16)
    tcc.cache_write(cache, y, 1, T=T, OC=OC)
    for p in range(T):
        want = y[:, p * OC : (p + 1) * OC].reshape(B, -1).to(torch.bfloat16)
        assert torch.equal(cache[(1 - p) % T, p], want)
    # The wrapper is the plain version on a CPU cache and launched nothing.
    assert tcc.cache_write.launches == 0


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(cache=torch.zeros((4, 3, 2, 8))), ValueError),  # P != T
        (dict(y=torch.zeros((2, 7, 2, 2))), ValueError),  # T*OC channels
        (dict(y=torch.zeros((2, 8, 2, 3))), ValueError),  # D
        (dict(cursor=4), ValueError),
        (dict(cursor=torch.tensor(1)), ValueError),  # the cursor is a host integer
        (dict(cache=torch.zeros((4, 4, 8, 2)).permute(0, 1, 3, 2)), ValueError),
    ],
)
def test_cache_write_checks_its_arguments(kwargs, error):
    args = dict(cache=torch.zeros((4, 4, 2, 8)), y=torch.zeros((2, 8, 2, 2)), cursor=0)
    args.update(kwargs)
    with pytest.raises(error, match="cache_write"):
        tcc.cache_write(args["cache"], args["y"], args["cursor"], T=4, OC=2)


@pytest.mark.parametrize("cursor", [0, 1, 2, 3])
def test_gather_sum_matches_jax(cursor):
    B, T, OC, OH, OW = 6, 4, 3, 4, 4
    rng = np.random.default_rng(20 + cursor)
    cache = rng.normal(0, 1, (T, T, OC * OH * OW, B)).astype(np.float32)
    valid = rng.random((B, T)) < 0.6
    want = np.asarray(jcc.gather_sum(jnp.asarray(cache), jnp.asarray(valid), cursor))  # (D, B)
    want = want.reshape(OH, OW, OC, B).transpose(3, 2, 0, 1).reshape(B, -1)
    got = tcc.gather_sum(
        conv1_cache_from_numpy(cache, (OH, OW, OC)), torch.from_numpy(valid), cursor
    )
    assert got.dtype == torch.float32 and got.shape == (B, OC * OH * OW)
    # The same T-term float32 sum in the same order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _nets(input_shape, seed=0, **kw):
    jnet = JaxCNN(input_shape=input_shape, hidden_dims=(24,), time_major_stack=True,
                  conv1_cache=True, **kw)
    tnet = CNNQValueNetwork(input_shape=input_shape, hidden_dims=(24,), time_major_stack=True,
                            conv1_cache=True, **kw)
    params = jnet.init(jax.random.PRNGKey(seed), 0, 0, A)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x if x.ndim > 1 else jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32)),
        params,
    )
    module = tnet.init(torch.Generator().manual_seed(seed), 0, 0, A)
    load_flax_cnn_q_params(module, jax.tree.map(np.asarray, params))
    return jnet, params, tnet, module


@pytest.mark.parametrize(
    "input_shape,kw",
    [((20, 20, 4), {}), ((12, 12, 3), dict(kernel_sizes=(4, 2), strides=(2, 1)))],
)
def test_network_cache_functions_match_jax(input_shape, kw):
    H, W, T = input_shape
    jnet, params, tnet, module = _nets(input_shape, **kw)
    _, _, _, k, s, OH, OW, OC = tnet._conv1_dims()
    assert tnet._conv1_dims() == jnet._conv1_dims()
    assert tnet.cache_dim() == jnet.cache_dim() and tnet.cache_enabled
    B = 5
    rng = np.random.default_rng(3)

    # _k64: (k, k, 1, T*OC) there, (T*OC, 1, k, k) here, channel p*OC + oc.
    want = np.asarray(jnet._k64(params, jnp.float32))
    with torch.no_grad():
        got = tnet._k64(module, torch.float32)
    assert got.shape == (T * OC, 1, k, k)
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=1e-7, atol=0)

    # _contrib_conv: (H, W, N, 1) -> (N, OH, OW, T*OC) there, NCHW here.
    frames = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    want = np.asarray(jnet._contrib_conv(params, jnp.asarray(frames.transpose(1, 2, 0))[..., None]))
    with torch.no_grad():
        got = tnet._contrib_conv(module, torch.from_numpy(frames)[:, None])
        got_y = tnet.cache_contrib_y(module, torch.from_numpy(frames).reshape(B, H * W))
    assert got.shape == (B, T * OC, OH, OW) and got.is_contiguous()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    assert torch.equal(got, got_y)

    # refresh_cache and _q_all_cached at every cursor with random validity.
    ring = rng.uniform(0, 255, (B, T, H * W)).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    for cursor in range(T):
        jview = JaxView(ring=jnp.asarray(ring), valid=jnp.asarray(valid),
                        cursor=jnp.asarray(cursor, jnp.int32))
        jcache = jnet.refresh_cache(params, jview)
        tview = frame_ring_view_from_numpy(ring, valid, cursor)
        tcache = tnet.refresh_cache(module, tview)
        assert tcache.shape == (T, T, B, OC * OH * OW) and tcache.dtype == torch.float32
        moved = conv1_cache_from_numpy(np.asarray(jcache), (OH, OW, OC))
        np.testing.assert_allclose(tcache.numpy(), moved.numpy(), **TOL)
        # A second refresh rewrites the same tensor.
        tview.cache = tcache
        assert tnet.refresh_cache(module, tview) is tcache

        want = np.asarray(jnet.q_all(params, jview.replace(cache=jcache), jnp.zeros((B, A, A))))
        with torch.no_grad():
            got = tnet.q_all(module, tview, None)
            # The JAX cache carried across gives the same Q.
            carried = frame_ring_view_from_numpy(
                ring, valid, cursor, cache=np.asarray(jcache), conv1_out=(OH, OW, OC))
            got_carried = tnet.q_all(module, carried, None)
            direct = tnet.q_all(module, dataclasses.replace(tview, cache=None), None)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got_carried.numpy(), want, **TOL)
        # The cached sum is grouped by frame, the direct one is one conv.
        np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-4, atol=2e-4)


def test_carrying_a_frame_ring_view_across():
    B, T, F, OH, OW, OC = 3, 2, 16, 2, 2, 3
    rng = np.random.default_rng(5)
    ring = rng.uniform(0, 255, (B, T, F)).astype(np.float32)
    cache = rng.normal(0, 1, (T, T, OH * OW * OC, B)).astype(np.float32)
    jview = JaxView(
        ring=jnp.asarray(ring).astype(jnp.bfloat16), valid=jnp.ones((B, T), bool),
        cursor=jnp.asarray(1, jnp.int32), cache=jnp.asarray(cache).astype(jnp.bfloat16),
    )
    view = frame_ring_view_from_numpy(
        _np32(jview.ring), np.asarray(jview.valid), int(jview.cursor), cache=_np32(jview.cache),
        conv1_out=(OH, OW, OC), dtype=torch.bfloat16,
    )
    assert isinstance(view, FrameRingView) and view.cursor == 1 and not view.from_replay
    assert view.ring.dtype == view.cache.dtype == torch.bfloat16 and view.valid.dtype == torch.bool
    np.testing.assert_array_equal(view.ring.float().numpy(), _np32(jview.ring))
    # Entry (j, p, b, (oc, oh, ow)) here is (j, p, (oh, ow, oc), b) there.
    assert view.cache.shape == (T, T, B, OC * OH * OW)
    there = _np32(jview.cache).reshape(T, T, OH, OW, OC, B)
    here = view.cache.float().numpy().reshape(T, T, B, OC, OH, OW)
    assert here[1, 0, 2, 1, 0, 1] == there[1, 0, 0, 1, 1, 2]
    with pytest.raises(ValueError, match="conv1_out"):
        frame_ring_view_from_numpy(ring, np.ones((B, T), bool), 0, cache=cache)
    with pytest.raises(ValueError, match="OH\\*OW\\*OC"):
        conv1_cache_from_numpy(cache, (OH, OW, OC + 1))


B_, H_, W_, T_ = 8, 12, 12, 4


def _agent_pair(conv1_cache, act_dtype=None, ring_dtype=None):
    net = dict(input_shape=(H_, W_, T_), kernel_sizes=(4, 2), strides=(2, 1), hidden_dims=(32,),
               time_major_stack=True, conv1_cache=conv1_cache)
    buf = dict(capacity=8 * B_, stack=T_, num_envs=B_, dedup_next=True)
    env = dict(height=H_, width=W_, frames=1, episode_len=5)
    jagent = JaxAgent(
        policy_learner=JaxDQN(
            q_network=JaxCNN(**net), training_rounds=1, batch_size=16,
            history_summarizer=JaxFrameRing(history_length=T_),
        ),
        replay_buffer=JaxVisual(**buf),
    ).for_env(JaxSyntheticAtari(**env))
    tagent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(**net), training_rounds=1, batch_size=16,
            act_dtype=act_dtype,
            history_summarizer=FrameRingHistorySummarization(history_length=T_, dtype=ring_dtype),
        ),
        replay_buffer=VisualReplayBuffer(frame_dtype=ring_dtype, **buf),
    ).for_env(SyntheticAtari(**env))
    return jagent, tagent


def _step_inputs(rng, step):
    """One env step's frames, rewards and flags: episodes of 5 lockstep
    steps (as `SyntheticAtari(episode_len=5)` truncates) and one early
    termination, from numpy."""
    F = H_ * W_
    obs = rng.uniform(0, 255, (B_, F)).astype(np.float32)
    fresh = rng.uniform(0, 255, (B_, F)).astype(np.float32)
    reward = rng.uniform(0, 1, B_).astype(np.float32)
    terminated = np.zeros(B_, bool)
    terminated[0] = step == 1
    truncated = np.full(B_, step % 5 == 4) & ~terminated
    done = terminated | truncated
    return obs, np.where(done[:, None], fresh, obs), reward, terminated, truncated


def test_cached_q_matches_direct_through_resets_and_learns():
    """The rollout of tests/test_conv_cache.py: 14 steps with resets and a
    learn every third step, the same frames, actions and sampled rows for a
    cached and a direct agent of the port and, until the first learn, for
    the cached JAX agent."""
    F, steps = H_ * W_, 14
    rng = np.random.default_rng(0)
    first = rng.uniform(0, 255, (B_, F)).astype(np.float32)
    jagent, cached = _agent_pair(True)
    _, direct = _agent_pair(False)
    jastate = jagent.init(jax.random.PRNGKey(0), F, B_, jnp.asarray(first))
    weights = jax.tree.map(np.asarray, jastate.learner.params)
    states = []
    for agent in (cached, direct):
        astate = agent.init(0, F, B_, torch.from_numpy(first), device="cpu")
        for module in (astate.learner.params, astate.learner.target_params):
            load_flax_cnn_q_params(module, weights)
        states.append(astate)
    cstate, dstate = states
    assert dstate.history_carry.cache is None
    # The cache was seeded at init with the agent's own weights; loading others
    # leaves it stale (as in the reference) until it is refreshed.
    net = cached.policy_learner.q_network
    stale = cstate.history_carry.cache.clone()
    assert net.refresh_cache(cstate.learner.params, cstate.history_carry) is cstate.history_carry.cache
    assert not torch.equal(stale, cstate.history_carry.cache)
    moved = conv1_cache_from_numpy(np.asarray(jastate.history_carry.cache), net._conv1_dims()[5:])
    np.testing.assert_allclose(cstate.history_carry.cache.numpy(), moved.numpy(), **TOL)

    jlearner = jagent.policy_learner
    key = jax.random.PRNGKey(1)
    learns = 0
    for step in range(steps):
        with torch.no_grad():
            qc = cached.policy_learner._scores(cstate.learner, cached.subjective_state(cstate), None)
            qd = direct.policy_learner._scores(dstate.learner, direct.subjective_state(dstate), None)
        # Tolerance, not bit equality: T partial convs summed against one conv.
        np.testing.assert_allclose(qc.numpy(), qd.numpy(), rtol=2e-4, atol=2e-4, err_msg=str(step))
        if learns == 0:
            jq = jlearner._scores(
                jastate.learner, jagent.subjective_state(jastate),
                jlearner.represented_candidates(B_), None,
            )
            np.testing.assert_allclose(qc.numpy(), np.asarray(jq), **TOL, err_msg=str(step))

        cstate, choice = cached.act(cstate, None, exploit=True)
        dstate, _ = direct.act(dstate, None, exploit=True)
        # The same actions go into both replays whatever a near-tie did.
        dstate.last_action = ActionChoice(action=choice.action.clone(), index=choice.index.clone())
        obs, next_obs, reward, terminated, truncated = _step_inputs(rng, step)
        tres = ActionResult(
            observation=torch.from_numpy(obs), reward=torch.from_numpy(reward),
            terminated=torch.from_numpy(terminated), truncated=torch.from_numpy(truncated),
        )
        cstate = cached.observe(cstate, tres, torch.from_numpy(next_obs))
        dstate = direct.observe(dstate, tres, torch.from_numpy(next_obs))
        assert torch.equal(cstate.history_carry.ring, dstate.history_carry.ring)
        if learns == 0:
            key, k_act, k_obs = jax.random.split(key, 3)
            jastate, _ = jagent.act(jastate, k_act, exploit=True)
            jastate = jastate.replace(last_action=jastate.last_action.replace(
                action=jnp.asarray(choice.action.numpy()), index=jnp.asarray(choice.index.numpy())))
            jres = JaxActionResult(
                observation=jnp.asarray(obs), reward=jnp.asarray(reward),
                terminated=jnp.asarray(terminated), truncated=jnp.asarray(truncated),
            )
            jastate = jagent.observe(jastate, jres, jnp.asarray(next_obs), k_obs)
            jcache = conv1_cache_from_numpy(
                np.asarray(jastate.history_carry.cache), net._conv1_dims()[5:])
            np.testing.assert_allclose(
                cstate.history_carry.cache.numpy(), jcache.numpy(), **TOL, err_msg=str(step))

        if step % 3 == 2:
            _, n_valid = cached.replay_buffer._sample_range(cstate.replay)
            rows = torch.from_numpy(rng.integers(0, n_valid, (1, 16)))
            old_cache = cstate.history_carry.cache.clone()
            cstate, cm = cached.learn(cstate, None, indices=rows)
            dstate, dm = direct.learn(dstate, None, indices=rows)
            learns += 1
            assert cm["loss"].item() == dm["loss"].item()  # the learn path is the same code
            for a, b in zip(cstate.learner.params.parameters(), dstate.learner.params.parameters()):
                assert torch.equal(a, b)
            # learn() left no stale contribution behind: the cache equals a
            # from-scratch recompute with the new weights, and it moved.
            view = cstate.history_carry
            scratch = net.refresh_cache(cstate.learner.params, dataclasses.replace(view, cache=None))
            assert scratch is not view.cache
            np.testing.assert_allclose(view.cache.numpy(), scratch.numpy(), rtol=1e-5, atol=1e-6)
            assert not torch.allclose(view.cache, old_cache)
    assert learns == 4 and cstate.replay.push_count == steps
    assert dstate.history_carry.cache is None  # conv1_cache=False never makes one


def test_cached_act_path_under_bfloat16_uses_the_same_weights_as_the_act_copy():
    # act_dtype="bfloat16" with a bfloat16 ring: the contrib conv casts the
    # float32 params to the ring's dtype, act reads the bfloat16 copy: the
    # same values. Cached and direct Q then differ by bfloat16 roundings only.
    F = H_ * W_
    rng = np.random.default_rng(1)
    first = rng.uniform(0, 255, (B_, F)).astype(np.float32)
    _, cached = _agent_pair(True, act_dtype="bfloat16", ring_dtype=torch.bfloat16)
    cstate = cached.init(0, F, B_, torch.from_numpy(first), device="cpu")
    net, learner = cached.policy_learner.q_network, cached.policy_learner
    assert cstate.history_carry.cache.dtype == torch.bfloat16
    with torch.no_grad():
        from_params = net._k64(cstate.learner.params, torch.bfloat16)
        from_copy = net._k64(learner._act_module(cstate.learner), torch.bfloat16)
    assert torch.equal(from_params, from_copy)
    for step in range(6):
        cstate, _ = cached.act(cstate, None, exploit=True)
        obs, next_obs, reward, terminated, truncated = _step_inputs(rng, step)
        tres = ActionResult(
            observation=torch.from_numpy(obs), reward=torch.from_numpy(reward),
            terminated=torch.from_numpy(terminated), truncated=torch.from_numpy(truncated),
        )
        cstate = cached.observe(cstate, tres, torch.from_numpy(next_obs))
        if step == 3:
            cstate, _ = cached.learn(cstate, None)
        view = cstate.history_carry
        with torch.no_grad():
            qc = learner._scores(cstate.learner, view, None)
            qd = learner._scores(cstate.learner, dataclasses.replace(view, cache=None), None)
        # Each path rounds conv1's output, conv2's and the hidden layer to
        # bfloat16 (2^-8 relative) at its own places; with |Q| under 2 the
        # two stay within 3e-2 (the bound test_torch_cnn.py uses).
        assert qc.dtype == torch.float32 and np.abs(qd.numpy()).max() < 2.0
        np.testing.assert_allclose(qc.numpy(), qd.numpy(), rtol=0, atol=3e-2)
        # The incremental cache equals a from-scratch one bit for bit here:
        # the same convolution of the same frames.
        scratch = net.refresh_cache(cstate.learner.params, dataclasses.replace(view, cache=None))
        assert torch.equal(view.cache, scratch)


def test_cache_options_and_errors(monkeypatch):
    ok = dict(input_shape=(20, 20, 4), time_major_stack=True, conv1_cache=True)
    assert CNNQValueNetwork(**ok).cache_enabled
    # Without time_major_stack there is no ring and the option is inert, as in
    # the reference.
    assert not CNNQValueNetwork(conv1_cache=True).cache_enabled
    assert not CNNQValueNetwork(time_major_stack=True).cache_enabled
    with pytest.raises(ValueError, match="frame_channels == 1"):
        CNNQValueNetwork(**{**ok, "input_shape": (20, 20, 16)}, frame_channels=4)
    with pytest.raises(ValueError, match="paddings\\[0\\] == 0"):
        CNNQValueNetwork(**ok, paddings=(1, 0))

    # A replay-sampled window never takes the cached branch, even if a cache
    # rides on the view.
    calls = []
    real = tcc.gather_sum
    import pearl_tpu_torch.neural_networks.q_value_networks as qvn

    monkeypatch.setattr(qvn, "gather_sum", lambda *a: calls.append(1) or real(*a))
    net = CNNQValueNetwork(**ok, hidden_dims=(16,))
    module = net.init(torch.Generator().manual_seed(0), 0, 0, A)
    view = FrameRingView(
        torch.rand((2, 4, 400)) * 255, torch.ones((2, 4), dtype=torch.bool), 0)
    view.cache = net.refresh_cache(module, view)
    with torch.no_grad():
        live = net.q_all(module, view, None)
        assert calls == [1]
        replayed = net.q_all(module, dataclasses.replace(view, from_replay=True), None)
        assert calls == [1]
    np.testing.assert_allclose(live.numpy(), replayed.numpy(), rtol=2e-4, atol=2e-4)

    # An agent whose network caches needs the params to seed per-env state.
    agent = _agent_pair(True)[1]
    with pytest.raises(ValueError, match="params"):
        agent.fresh_per_env_state(H_ * W_, B_, torch.zeros((B_, H_ * W_)), "cpu")
    assert agent._cache_net is agent.policy_learner.q_network
    assert _agent_pair(False)[1]._cache_net is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    B, T, OC, OH, OW = 37, 3, 5, 3, 5  # chunks of 75 elements: narrow words
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.randn((T, T, B, OC * OH * OW), device="cuda", generator=gen).to(dtype)
    y = torch.randn((B, T * OC, OH, OW), device="cuda", generator=gen).to(dtype)
    for cursor in range(T):
        before = tcc.cache_write.launches
        got = tcc.cache_write(cache.clone(), y, cursor, T=T, OC=OC)
        torch.cuda.synchronize()
        assert tcc.cache_write.launches == before + 1
        want = tcc.cache_write_reference(cache.clone(), y, cursor, T=T, OC=OC)
        assert torch.equal(got, want)
