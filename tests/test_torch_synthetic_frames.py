"""`ops.synthetic_frames` (SyntheticAtari's step and auto-reset frames in one
kernel) and the `step_autoreset` hook that `VectorEnv.step` takes with it.

On the CPU: the plain version equals two `SyntheticAtari._obs` grids and a
`where` bit for bit; the hook's path, driven on CPU tensors, gives what
today's path gives and leaves the generator where it does; CPU runs, other
envs and the `fresh=` path keep today's code. On the card, at the
benchmark's size and at a small float32 one, the kernel's path equals
today's bit for bit, with one launch a step and no `_obs` call. Imports no
JAX, so that the card tests run on a machine without it (`pytest
--noconftest -m cuda` there).
"""

import dataclasses

import pytest
import torch

from pearl_tpu_torch.envs import CartPole, SyntheticAtari, SyntheticAtariState
from pearl_tpu_torch.envs.vector import VectorEnv
from pearl_tpu_torch.ops import synthetic_frames, synthetic_frames_reference
from pearl_tpu_torch.utils.pytree import tree_select

BF16, F32 = torch.bfloat16, torch.float32
DONE = {
    "none": lambda B: torch.zeros(B, dtype=torch.bool),
    "some": lambda B: torch.arange(B) % 3 == 1,
    "all": lambda B: torch.ones(B, dtype=torch.bool),
}


def _state(B, gen, device="cpu", episode_len=128):
    phase = torch.rand((B,), generator=gen, device=device) * 6.28
    t = torch.randint(0, episode_len, (B,), generator=gen, device=device, dtype=torch.int32)
    return SyntheticAtariState(phase=phase, t=t)


def _today(env, venv, states, actions, gen):
    """`VectorEnv.step`'s path before the hook: `step`, `reset`, a select."""
    new_states, results = env.step(states, actions)
    fresh_states, fresh_obs = venv.reset(gen)
    done = results.done
    return (tree_select(done, fresh_states, new_states), results,
            tree_select(done, fresh_obs, results.observation))


def _assert_same(got, want):
    (gs, gr, gn), (ws, wr, wn) = got, want
    assert torch.equal(gs.phase, ws.phase) and torch.equal(gs.t, ws.t)
    assert gs.t.dtype == ws.t.dtype == torch.int32
    for name in ("observation", "reward", "terminated", "truncated"):
        a, b = getattr(gr, name), getattr(wr, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert gn.dtype == wn.dtype and torch.equal(gn, wn)


@pytest.mark.parametrize("done", sorted(DONE))
@pytest.mark.parametrize("frames,H,W", [(1, 84, 84), (4, 7, 5)])
@pytest.mark.parametrize("obs_dtype", [BF16, F32, None])
def test_reference_equals_two_obs_grids_and_a_where(obs_dtype, frames, H, W, done):
    B = 6
    gen = torch.Generator().manual_seed(frames * 10 + H)
    env = SyntheticAtari(height=H, width=W, frames=frames, obs_dtype=obs_dtype)
    state = _state(B, gen)
    fresh_phase = torch.rand((B,), generator=gen) * 6.28
    mask = DONE[done](B)
    obs = env._obs(SyntheticAtariState(phase=state.phase, t=state.t + 1))
    fresh = env._obs(SyntheticAtariState(phase=fresh_phase, t=torch.zeros_like(state.t)))
    dtype = obs_dtype or F32
    got_obs, got_next = synthetic_frames_reference(
        state.phase, state.t, fresh_phase, mask, H=H, W=W, frames=frames, dtype=dtype)
    assert got_obs.dtype == got_next.dtype == dtype
    assert got_obs.shape == got_next.shape == (B, H * W * frames)
    assert torch.equal(got_obs, obs)
    assert torch.equal(got_next, torch.where(mask[:, None], fresh, obs))
    # The public op on CPU tensors runs the plain version and counts no launch.
    before = synthetic_frames.launches
    op_obs, op_next = synthetic_frames(
        state.phase, state.t, fresh_phase, mask, H=H, W=W, frames=frames, dtype=dtype)
    assert synthetic_frames.launches == before
    assert torch.equal(op_obs, obs) and torch.equal(op_next, got_next)


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(t=torch.zeros(4, dtype=torch.int64)), TypeError),
        (dict(phase=torch.zeros(4, dtype=torch.float64)), TypeError),
        (dict(fresh_phase=torch.zeros(3)), TypeError),
        (dict(done=torch.zeros(4, dtype=torch.uint8)), TypeError),
        (dict(phase=torch.zeros(8)[::2]), ValueError),
        (dict(dtype=torch.float16), TypeError),
        (dict(H=0), ValueError),
    ],
)
def test_op_rejects_what_the_kernel_does_not_take(change, error):
    args = dict(phase=torch.zeros(4), t=torch.zeros(4, dtype=torch.int32),
                fresh_phase=torch.zeros(4), done=torch.zeros(4, dtype=torch.bool),
                H=3, W=2, frames=1, dtype=BF16)
    args.update(change)
    with pytest.raises(error):
        synthetic_frames(**args)


def _fused_on_cpu(monkeypatch):
    """Let the hook take its path on CPU tensors, where the op runs its plain
    version: the hook's own logic, tested without a card."""
    monkeypatch.setattr(SyntheticAtari, "_frames_kernel_applies",
                        staticmethod(lambda device, dtype: True))


@pytest.mark.parametrize("obs_dtype,frames,H,W", [(BF16, 1, 84, 84), (F32, 4, 7, 5)])
def test_hook_path_equals_today_and_draws_the_same(monkeypatch, obs_dtype, frames, H, W):
    B, episode_len = 9, 4
    env = SyntheticAtari(height=H, width=W, frames=frames, episode_len=episode_len,
                         obs_dtype=obs_dtype)
    venv = VectorEnv(env, B, torch.device("cpu"))
    init = _state(B, torch.Generator().manual_seed(1), episode_len=episode_len)
    g_today, g_hook = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    s_today = s_hook = init
    _fused_on_cpu(monkeypatch)
    for step in range(2 * episode_len):  # every row finishes an episode, some twice
        actions = torch.randint(0, 6, (B, 1), generator=torch.Generator().manual_seed(step))
        want = _today(env, venv, s_today, actions, g_today)
        got = venv.step(s_hook, actions, g_hook)
        _assert_same(got, want)
        assert torch.equal(g_hook.get_state(), g_today.get_state())
        s_today, s_hook = want[0], got[0]


def test_hook_path_makes_no_obs_grid(monkeypatch):
    env = SyntheticAtari(height=6, width=6, frames=1, obs_dtype=BF16)
    venv = VectorEnv(env, 4, torch.device("cpu"))
    _fused_on_cpu(monkeypatch)

    def no_grid(self, state):
        raise AssertionError("the hook's path makes no _obs grid")

    monkeypatch.setattr(SyntheticAtari, "_obs", no_grid)
    state = _state(4, torch.Generator().manual_seed(0))
    venv.step(state, torch.zeros((4, 1), dtype=torch.int64), torch.Generator().manual_seed(0))


@pytest.mark.parametrize(
    "device,dtype,applies",
    [("cuda", BF16, True), ("cuda", F32, True), ("cuda", torch.float16, False),
     ("cpu", BF16, False), ("cpu", F32, False)],
)
def test_kernel_applies_rule(device, dtype, applies):
    assert SyntheticAtari._frames_kernel_applies(torch.device(device), dtype) is applies


@pytest.mark.parametrize("obs_dtype", [BF16, None, torch.float16])
def test_cpu_and_fresh_paths_keep_today(monkeypatch, obs_dtype):
    """On CPU tensors the hook declines and `VectorEnv.step` runs `step`,
    `reset` and the select through `_obs`, two grids a step; with `fresh=`
    the hook is not asked at all."""
    B = 5
    env = SyntheticAtari(height=5, width=4, frames=2, episode_len=3, obs_dtype=obs_dtype)
    venv = VectorEnv(env, B, torch.device("cpu"))
    state = _state(B, torch.Generator().manual_seed(2), episode_len=3)
    actions = torch.zeros((B, 1), dtype=torch.int64)
    grids = []
    obs = SyntheticAtari._obs
    monkeypatch.setattr(SyntheticAtari, "_obs", lambda self, s: grids.append(1) or obs(self, s))
    want = _today(env, venv, state, actions, torch.Generator().manual_seed(3))
    grids.clear()
    got = venv.step(state, actions, torch.Generator().manual_seed(3))
    assert len(grids) == 2
    _assert_same(got, want)

    def not_asked(*args):
        raise AssertionError("the fresh= path does not ask the hook")

    monkeypatch.setattr(SyntheticAtari, "step_autoreset", not_asked)
    fresh = venv.reset(torch.Generator().manual_seed(3))
    _assert_same(venv.step(state, actions, fresh=fresh), want)


def test_other_envs_keep_today():
    env = CartPole()
    assert not hasattr(env, "step_autoreset")
    venv = VectorEnv(env, 6, torch.device("cpu"))
    states, _ = venv.reset(torch.Generator().manual_seed(0))
    actions = torch.ones((6, 1), dtype=torch.int64)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    got_s, got_r, got_n = venv.step(states, actions, g1)
    new_states, results = env.step(states, actions)
    fresh_states, fresh_obs = venv.reset(g2)
    want_s = tree_select(results.done, fresh_states, new_states)
    for f in dataclasses.fields(want_s):
        assert torch.equal(getattr(got_s, f.name), getattr(want_s, f.name))
    assert torch.equal(got_r.observation, results.observation)
    assert torch.equal(got_n, tree_select(results.done, fresh_obs, results.observation))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,W,frames,obs_dtype",
    [(16384, 84, 84, 1, BF16),  # the benchmark's cells
     (37, 7, 5, 4, F32),  # rows of 140 floats, a multiple of the 4-float word
     (19, 5, 3, 3, BF16),  # rows of 45 bf16: the one-element body
     (8, 84, 84, 4, None)],
)
def test_card_path_equals_today(monkeypatch, B, H, W, frames, obs_dtype):
    """Over 2 x 128 steps from random step counts, so that rows finish in
    every step: states, results and frames `torch.equal` to today's path, the
    generator where today's leaves it, one launch a step, no `_obs`."""
    device = _card()
    episode_len = 128
    env = SyntheticAtari(height=H, width=W, frames=frames, episode_len=episode_len,
                         obs_dtype=obs_dtype)
    venv = VectorEnv(env, B, device)
    init = _state(B, torch.Generator(device=device).manual_seed(11), device, episode_len)
    g_today = torch.Generator(device=device).manual_seed(5)
    g_hook = torch.Generator(device=device).manual_seed(5)
    s_today = s_hook = init
    grids = []
    obs = SyntheticAtari._obs
    monkeypatch.setattr(SyntheticAtari, "_obs", lambda self, s: grids.append(1) or obs(self, s))
    steps = 2 * episode_len if B < 1024 else 3
    for step in range(steps):
        if B >= 1024:  # at the cells' size: some rows done in each checked step
            s_today = s_hook = dataclasses.replace(
                init, t=(init.t + step * 40) % episode_len)
        actions = torch.randint(0, 6, (B, 1), device=device,
                                generator=torch.Generator(device=device).manual_seed(step))
        want = _today(env, venv, s_today, actions, g_today)
        grids.clear()
        before = synthetic_frames.launches
        got = venv.step(s_hook, actions, g_hook)
        assert synthetic_frames.launches == before + 1
        assert not grids
        _assert_same(got, want)
        assert torch.equal(g_hook.get_state(), g_today.get_state())
        if B >= 1024:
            assert 0 < int(want[1].done.sum()) < B
        s_today, s_hook = want[0], got[0]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("done", sorted(DONE))
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_card_kernel_equals_plain_version(done, dtype):
    device = _card()
    B, H, W, frames = 300, 84, 84, 4
    gen = torch.Generator(device=device).manual_seed(3)
    phase = torch.rand((B,), generator=gen, device=device) * 6.28
    t = torch.randint(0, 128, (B,), generator=gen, device=device, dtype=torch.int32)
    fresh = torch.rand((B,), generator=gen, device=device) * 6.28
    mask = DONE[done](B).to(device)
    got = synthetic_frames(phase, t, fresh, mask, H=H, W=W, frames=frames, dtype=dtype)
    want = synthetic_frames_reference(phase, t, fresh, mask, H=H, W=W, frames=frames, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
