"""`VisualReplayBuffer` of the PyTorch port (pearl_tpu_torch/replay_buffers/
visual.py) against the JAX buffer (pearl_tpu/replay_buffers/visual.py): a
scripted multi-episode stream with terminations, truncations and a ring wrap
is pushed into both, and the same rows — the JAX buffer's own draws, handed to
the port — are rebuilt by both, in both `dedup_next` modes. Frames are moved,
masked and cast, never computed on, so batches are compared exactly.

A push writes its sequence tag without copying a host scalar into the
storage (on the card such a copy waits for the device), pinned here by the
ATen ops a push issues; `test_torch_tracing.py` checks it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu.replay_buffers.visual import VisualReplayBuffer as JaxVisual
from pearl_tpu_torch.replay_buffers import TransitionBatch, VisualReplayBuffer

torch.set_num_threads(1)

B, T, F = 3, 3, 6
CAP_PUSHES = 5
FIELDS = ("state", "next_state", "reward", "action", "terminated", "truncated", "action_index")


def _examples(stored_dim=T * F):
    jex = JaxBatch(
        state=jnp.zeros((1, stored_dim)), action=jnp.zeros((1, 1)), reward=jnp.zeros((1,)),
        next_state=jnp.zeros((1, stored_dim)), terminated=jnp.zeros((1,), bool),
        truncated=jnp.zeros((1,), bool), action_index=jnp.zeros((1,), jnp.int32),
    )
    tex = TransitionBatch(
        state=torch.zeros((1, stored_dim)), action=torch.zeros((1, 1)), reward=torch.zeros((1,)),
        next_state=torch.zeros((1, stored_dim)), terminated=torch.zeros((1,), dtype=torch.bool),
        truncated=torch.zeros((1,), dtype=torch.bool),
        action_index=torch.zeros((1,), dtype=torch.int32),
    )
    return jex, tex


def _stream(n_pushes, seed=0):
    """Per push: frame_s, frame_n, action, reward, terminated, truncated,
    action_index as numpy. Env 0 terminates at pushes 2 and 7, env 1 is
    truncated at push 4 and env 2 at push 8; within an episode frame_n of one
    push is frame_s of the next, after an episode's end frame_s is fresh."""
    rng = np.random.default_rng(seed)
    term = np.zeros((n_pushes, B), bool)
    trunc = np.zeros((n_pushes, B), bool)
    for p, e in ((2, 0), (7, 0)):
        if p < n_pushes:
            term[p, e] = True
    for p, e in ((4, 1), (8, 2)):
        if p < n_pushes:
            trunc[p, e] = True
    pushes = []
    frame_s = rng.uniform(0, 255, (B, F)).astype(np.float32)
    for p in range(n_pushes):
        frame_n = rng.uniform(0, 255, (B, F)).astype(np.float32)
        pushes.append(dict(
            frame_s=frame_s, frame_n=frame_n,
            action=rng.integers(0, 6, (B, 1)).astype(np.float32),
            reward=rng.uniform(0, 1, B).astype(np.float32),
            terminated=term[p], truncated=trunc[p],
            action_index=rng.integers(0, 6, B).astype(np.int32),
        ))
        fresh = rng.uniform(0, 255, (B, F)).astype(np.float32)
        done = term[p] | trunc[p]
        frame_s = np.where(done[:, None], fresh, frame_n)
    return pushes


def _rest(p, lib):
    if lib is jnp:
        return JaxBatch(
            state=None, action=jnp.asarray(p["action"]), reward=jnp.asarray(p["reward"]),
            next_state=None, terminated=jnp.asarray(p["terminated"]),
            truncated=jnp.asarray(p["truncated"]), action_index=jnp.asarray(p["action_index"]),
        )
    return TransitionBatch(
        state=None, action=torch.from_numpy(p["action"]), reward=torch.from_numpy(p["reward"]),
        next_state=None, terminated=torch.from_numpy(p["terminated"]),
        truncated=torch.from_numpy(p["truncated"]),
        action_index=torch.from_numpy(p["action_index"]),
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _jax_draws(jbuf, jstate, key, batch_size):
    """The rows `jbuf.sample` draws with `key` (visual.py:277-282)."""
    pc = int(jstate.push_count)
    cap_pushes = jbuf.capacity // jbuf.num_envs
    oldest = 0 if pc <= cap_pushes else pc - cap_pushes + (jbuf.stack - 1)
    n_valid = max(pc - (1 if jbuf.dedup_next else 0) - oldest, 1) * jbuf.num_envs
    return np.array(jax.random.randint(key, (batch_size,), 0, n_valid)), n_valid


def _same_batch(tbatch, jbatch):
    for f in FIELDS:
        got, want = getattr(tbatch, f), getattr(jbatch, f)
        assert tuple(got.shape) == tuple(want.shape), f
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=f)
    assert tbatch.state.dtype == tbatch.next_state.dtype == torch.float32


@pytest.mark.parametrize("dedup_next", [False, True])
@pytest.mark.parametrize("tdtype,jdtype", [(None, None), (torch.bfloat16, jnp.bfloat16)])
def test_scripted_stream_samples_like_the_jax_buffer(dedup_next, tdtype, jdtype):
    kw = dict(capacity=CAP_PUSHES * B, stack=T, num_envs=B, dedup_next=dedup_next)
    jbuf, tbuf = JaxVisual(frame_dtype=jdtype, **kw), VisualReplayBuffer(frame_dtype=tdtype, **kw)
    jex, tex = _examples()
    jstate, tstate = jbuf.init(jex), tbuf.init(tex)
    assert set(tstate.storage) == set(jstate.storage)
    assert tbuf.min_pushes_before_sample == jbuf.min_pushes_before_sample == (2 if dedup_next else 1)
    assert tbuf.supports_frame_push and not tbuf.supports_deferred_push
    checked = 0
    for i, p in enumerate(_stream(11)):
        jstate = jbuf.push_frames(
            jstate, jnp.asarray(p["frame_s"]), jnp.asarray(p["frame_n"]), _rest(p, jnp)
        )
        tstate = tbuf.push_frames(
            tstate, torch.from_numpy(p["frame_s"]), torch.from_numpy(p["frame_n"]), _rest(p, torch)
        )
        assert tstate.push_count == int(jstate.push_count) == i + 1
        assert tstate.cursor == int(jstate.cursor) and tstate.size == int(jstate.size)
        np.testing.assert_array_equal(_np(tstate.storage["seq"]), _np(jstate.storage["seq"]))
        np.testing.assert_array_equal(
            _np(tstate.storage["frame_s"]), _np(jstate.storage["frame_s"])
        )
        if i + 1 < tbuf.min_pushes_before_sample:
            continue
        key = jax.random.PRNGKey(i)
        q, n_valid = _jax_draws(jbuf, jstate, key, 96)
        assert tbuf._sample_range(tstate)[1] == n_valid
        assert len(set(q.tolist())) == n_valid  # 96 draws reach every sampled row
        jbatch = jbuf.sample(jstate, key, 96)
        _same_batch(tbuf.sample(tstate, None, 96, indices=torch.from_numpy(q)), jbatch)
        _same_batch(tbuf.gather(tstate, torch.from_numpy(q)), jbatch)
        checked += 1
    assert checked >= 9 and tstate.push_count > 2 * CAP_PUSHES  # wrapped twice
    if dedup_next:
        # The side ring agrees wherever a resident row is truncated (the
        # port writes the masked slab on every push, the reference only on
        # pushes with a truncation: other rows may differ and are never read).
        trunc = tstate.storage["rest"].truncated.numpy()
        assert trunc.any()
        np.testing.assert_array_equal(
            _np(tstate.storage["frame_t"])[trunc], _np(jstate.storage["frame_t"])[trunc]
        )
        assert "frame_n" not in tstate.storage
    else:
        np.testing.assert_array_equal(
            _np(tstate.storage["frame_n"]), _np(jstate.storage["frame_n"])
        )


@pytest.mark.parametrize("dedup_next", [False, True])
def test_sampled_rows_follow_the_documented_reconstruction(dedup_next):
    # Frames tagged by push number: state stacks end in the row's own push,
    # older frames stop at an episode boundary, and next stacks end in the
    # successor, the side ring (truncated) or zero (terminated).
    tbuf = VisualReplayBuffer(capacity=8 * B, stack=T, num_envs=B, dedup_next=dedup_next)
    tstate = tbuf.init(_examples()[1])
    for p in range(6):
        rest = TransitionBatch(
            state=None, action=torch.zeros((B, 1)), reward=torch.full((B,), float(p)),
            next_state=None, terminated=torch.full((B,), p == 2), truncated=torch.full((B,), p == 3),
            action_index=torch.zeros((B,), dtype=torch.int32),
        )
        tstate = tbuf.push_frames(
            tstate, torch.full((B, F), float(p)), torch.full((B, F), 100.0 + p), rest
        )
    gen = torch.Generator().manual_seed(0)
    batch = tbuf.sample(tstate, gen, 128)
    pushes = batch.reward.numpy().astype(int)
    states = batch.state.reshape(128, T, F)[:, :, 0].numpy()
    nexts = batch.next_state.reshape(128, T, F)[:, :, 0].numpy()
    assert set(pushes) == set(range(5 if dedup_next else 6))
    first_of_episode = {0: 0, 1: 0, 2: 0, 3: 3, 4: 4, 5: 4}
    for p, s_row, n_row in zip(pushes, states, nexts):
        want = [float(k) if k >= first_of_episode[p] else 0.0 for k in range(p - T + 1, p + 1)]
        np.testing.assert_array_equal(s_row, want)
        np.testing.assert_array_equal(n_row[:-1], s_row[1:])
        if not dedup_next or p == 3:
            assert n_row[-1] == 100.0 + p  # stored frame_n, or the side ring
        elif p == 2:
            assert n_row[-1] == 0.0  # terminated: no TD target reads it
        else:
            assert n_row[-1] == p + 1  # the successor row's frame_s


def test_push_of_full_stacks_and_clear_match_jax():
    kw = dict(capacity=4 * B, stack=T, num_envs=B)
    jbuf, tbuf = JaxVisual(**kw), VisualReplayBuffer(**kw)
    jex, tex = _examples()
    jstate, tstate = jbuf.init(jex), tbuf.init(tex)
    rng = np.random.default_rng(3)
    for p in _stream(3, seed=3):
        stack = rng.uniform(0, 255, (B, T * F)).astype(np.float32)
        nstack = rng.uniform(0, 255, (B, T * F)).astype(np.float32)
        jb = _rest(p, jnp).replace(state=jnp.asarray(stack), next_state=jnp.asarray(nstack))
        tb = _rest(p, torch)
        tb.state, tb.next_state = torch.from_numpy(stack), torch.from_numpy(nstack)
        jstate, tstate = jbuf.push(jstate, jb), tbuf.push(tstate, tb)
    np.testing.assert_array_equal(_np(tstate.storage["frame_s"]), _np(jstate.storage["frame_s"]))
    np.testing.assert_array_equal(_np(tstate.storage["frame_n"]), _np(jstate.storage["frame_n"]))
    key = jax.random.PRNGKey(0)
    q, _ = _jax_draws(jbuf, jstate, key, 32)
    _same_batch(tbuf.gather(tstate, torch.from_numpy(q)), jbuf.sample(jstate, key, 32))

    jstate, tstate = jbuf.clear(jstate), tbuf.clear(tstate)
    assert tstate.push_count == tstate.size == tstate.cursor == 0
    np.testing.assert_array_equal(_np(tstate.storage["seq"]), _np(jstate.storage["seq"]))


def test_sample_indices_cover_exactly_the_sampled_rows():
    tbuf = VisualReplayBuffer(capacity=CAP_PUSHES * B, stack=T, num_envs=B, dedup_next=True)
    tstate = tbuf.init(_examples()[1])
    for p in _stream(8):
        tstate = tbuf.push_frames(
            tstate, torch.from_numpy(p["frame_s"]), torch.from_numpy(p["frame_n"]), _rest(p, torch)
        )
    # 8 pushes in a ring of 5: the oldest T-1 resident and the newest are out.
    oldest, n_valid = tbuf._sample_range(tstate)
    assert (oldest, n_valid) == (8 - 5 + (T - 1), (5 - (T - 1) - 1) * B)
    gen = torch.Generator().manual_seed(0)
    q = tbuf.sample_indices(tstate, gen, 512)
    assert q.min() == 0 and q.max() == n_valid - 1
    again = tbuf.sample_indices(tstate, torch.Generator().manual_seed(0), 512)
    assert torch.equal(q, again)  # seeded


def test_init_and_push_checks():
    _, tex = _examples()
    with pytest.raises(ValueError, match="multiple of"):
        VisualReplayBuffer(capacity=10, stack=T, num_envs=B).init(tex)
    with pytest.raises(ValueError, match="stack\\*num_envs"):
        VisualReplayBuffer(capacity=2 * B, stack=T, num_envs=B).init(tex)
    with pytest.raises(ValueError, match="not stack="):
        VisualReplayBuffer(capacity=8 * B, stack=4, num_envs=B).init(tex)
    tbuf = VisualReplayBuffer(capacity=8 * B, stack=T, num_envs=B, dedup_next=True)
    tstate = tbuf.init(tex)
    p = _stream(1)[0]
    with pytest.raises(ValueError, match="exactly num_envs"):
        tbuf.push_frames(tstate, torch.zeros((B + 1, F)), torch.zeros((B + 1, F)), _rest(p, torch))
    with pytest.raises(ValueError, match="post-step frame"):
        tbuf.push_frames(tstate, torch.zeros((B, F)), None, _rest(p, torch))
    assert tstate.storage["frame_t"].dtype == torch.float32
    bf = VisualReplayBuffer(
        capacity=8 * B, stack=T, num_envs=B, frame_dtype=torch.bfloat16
    ).init(tex)
    assert bf.storage["frame_s"].dtype == bf.storage["frame_n"].dtype == torch.bfloat16
    assert bf.storage["rest"].reward.shape == (8 * B,) and bf.storage["rest"].state is None


class _Ops(TorchDispatchMode):
    """Records each ATen op with its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


def _push_args(pushes, device="cpu"):
    """(frame_s, frame_n, rest) of each push of a `_stream`, on `device`."""
    for p in pushes:
        rest = _rest(p, torch)
        rest = TransitionBatch(**{f: None if getattr(rest, f) is None else
                                  getattr(rest, f).to(device) for f in FIELDS})
        yield (torch.from_numpy(p["frame_s"]).to(device),
               torch.from_numpy(p["frame_n"]).to(device), rest)


@pytest.mark.parametrize("dedup_next", [False, True])
def test_push_writes_its_tag_without_a_host_scalar_copy(dedup_next):
    # 11 pushes through a ring of 5 slabs: the tags wrap twice. A 0-dim
    # source of a copy_ is a host scalar lifted into a tensor, the write that
    # waits for the device on the card; the tag must go in as fill_'s value.
    tbuf = VisualReplayBuffer(capacity=CAP_PUSHES * B, stack=T, num_envs=B,
                              dedup_next=dedup_next, frame_dtype=torch.bfloat16)
    tstate = tbuf.init(_examples()[1])
    seq = tstate.storage["seq"]
    calls = []
    for i, args in enumerate(_push_args(_stream(11))):
        with _Ops() as ops:
            tstate = tbuf.push_frames(tstate, *args)
        calls += ops.calls
        assert seq[i % CAP_PUSHES].item() == i  # this push's count, across the wrap
    scalar_copies = [args for func, args in calls
                     if func is torch.ops.aten.copy_.default and args[1].dim() == 0]
    assert scalar_copies == []
    tag_fills = [args[1] for func, args in calls if func is torch.ops.aten.fill_.Scalar]
    assert tag_fills == list(range(11))
    assert tstate.push_count == 11
    assert seq.tolist() == [10, 6, 7, 8, 9]  # slot p % 5 holds the newest push p
