"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: needs CUDA (exits non-zero without it); prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles every kernel of the port from `pearl_tpu_torch/csrc`
     (one nvcc per source, all at once);
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes the main paths give it (and at ragged ones), every body of
     `fused_mlp` (rows, tiled, general) and of `ring_conv1` (mma, general)
     at shapes it takes, each C entry's choice of body against its Python
     mirror; times kernel, plain version and, where one PyTorch call computes
     the same function, that call, with CUDA events, beside an empty kernel
     launch and a probe of the card's float32 FMA rate;
  4. runner: drives `make_compiled_runner` at the full width of the DQN
     CartPole workload (131072 envs) and checks that every Q evaluation went
     through the kernel, the act launches through the tiled body and the
     learn launches through the rows body;
  5. learning: `online_learning` must reach CartPole return 500;
  6. visual runner: drives `make_compiled_runner` at the full width of the
     CNN-DQN workload (1024 envs, 84x84 frames, a window of 4, bfloat16 ring
     and replay) and checks the exact launch counts of the ring and fence
     kernels, the ring and replay bookkeeping and the Q values; then the
     same composition, at the same width, on the env's default 4-channel
     frames (a 231 MB ring), the path of `masked_scale_fence`; then the two
     opt-in act paths of the 1-channel composition, each at full width: the
     conv1 cache (`conv1_cache=True`, the path of `cache_write`) and the ring
     conv (`ring_conv=True`, the path of `ring_conv1`, every launch in the
     tensor-core body);
  7. csac runner: drives `make_compiled_runner` at the full width of the
     continuous SAC workload (Pendulum, 131072 envs, batch 1024, a replay of
     2097152 rows, 8 steps per learn, 16 learns per call): a warm-up call
     that checks every action, four timed calls, a profiled call, and the
     device kernels of one env step and of one learn. This path reaches no
     kernel of the port: actor and twin critic are plain PyTorch products,
     as the reference computes them outside Pallas;
  8. ddpg and td3 runners: the same width, a warm-up and a timed call each,
     and TD3's delay gate held exactly;
  9. continuous learning: `online_learning` with continuous SAC must reach
     Pendulum -250;
 10. ppo runner: drives `make_compiled_runner` at the full width of the PPO
     workload (CartPole, 131072 envs, a rollout of 8 steps, one round of
     1024 rows per learn, 16 learns per call): a warm-up call and four timed
     ones, the rollout buffer full before and empty after every learn, a
     profiled call and the device kernels of one env step and of one learn;
 11. ppo learning: `online_learning` with PPO must reach CartPole 500;
 12. discrete actor-critic: discrete SAC at 1024 CartPole envs through the
     runner, with one act, env step, observe and learn that must make no
     host sync; then one learn each of REINFORCE and PPO with the CNN actor
     and value network and of discrete SAC with the CNN twin critic, on
     SyntheticAtari frames at 64 envs.
 13. driver: `online_learning(stats="summary")` with the headline agent at
     its width (bench.py:409-466: 131072 envs, 8 steps per learn, 64 chunks
     per dispatch): a warm-up run of 2 dispatches, a timed run of 5 with
     B1's launches by body (act tiled, learn rows), one dispatch timed
     alone, one under `set_sync_debug_mode("error")` (the host fetch
     excluded) and one profiled (the idle share);
 14. curves: the same with stats="curves" (bench.py:343-407): the sampled
     stream (curve_capacity 131072) with a dispatch under the sync check and
     a profiled one, the lossless configuration (1 chunk per dispatch),
     which must drop no episode, and curves equal to full bit for bit at
     1024 envs;
 15. deferred runner: `make_compiled_runner(deferred_push=True)` at the
     headline width beside the per-step runner, in the order per-step,
     deferred, deferred, per-step; one deferred driver dispatch under the
     sync check;
 16. dqn family: Dueling DQN, QR-DQN risk-neutral and mean-variance, deep
     SARSA, and the multi-head DQN with Warmup(Boltzmann) and with each
     tie-breaking strategy, at 1024 CartPole envs through the runner.
 Phases 7-12 reach no kernel of the port (their products are PyTorch's);
 13-15 reach B1 as the runner does, 16 through its multi-head DQNs.
Then one JSON line for the kernels, the card line, and the final JSON line.
Any failure raises before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

ACT_SHAPE = (131_072, (4, 64, 64, 2))
LEARN_SHAPE = (1_024, (4, 64, 64, 2))
WIDE_DIMS = (7, 96, 130, 5)  # a layer wider than the tiled body takes
CHECK_SHAPES = [
    ACT_SHAPE, LEARN_SHAPE, (1_031, (5, 32, 48, 16, 3)), (37, (4, 64, 64, 2)),
    # A B that is no multiple of the tiled body's 128 rows, column tiles of
    # 8, 16 and 4 in one chain, and the wide chain in the rows and the
    # general body. `check_fused_mlp` adds the two B around the switch from
    # the rows body to the others, which depends on the card's SM count.
    (20_011, (4, 64, 64, 2)), (9_001, (5, 32, 48, 16, 3)), (300, WIDE_DIMS),
    (9_001, WIDE_DIMS),
]


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, launches=25, sleep_cycles=40_000_000, flush=None):
    """Median device time of one call of `fn`, in ms. A long sleep kernel is
    queued first so that every timed call is enqueued before the card
    reaches it: the events then time the card, not the host. With `flush`, a
    buffer larger than the L2 cache, the buffer is rewritten before every
    timed call, so that the call finds its operands in device memory as it
    does on the main path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(launches)]
    torch.cuda._sleep(sleep_cycles)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def mlp_operands(B, dims, gen):
    x = torch.randn((B, dims[0]), device="cuda", generator=gen)
    wb = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = math.sqrt(6.0 / (d_in + d_out))
        wb.append((torch.rand((d_out, d_in), device="cuda", generator=gen) * 2 - 1) * bound)
        wb.append(torch.randn((d_out,), device="cuda", generator=gen) * 0.1)
    return x, wb


def mlp_bound_ms(B, dims):
    """Least time for the chain on the card: the larger of its bytes (x, the
    weights and the output, each moved once) over the memory rate and its
    float32 operations over the CUDA-core rate."""
    params = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (B * dims[0] + params + B * dims[-1])
    flops = 2 * B * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_fused_mlp(card):
    """B1 against its plain version at every checked shape, each body at
    least at two; the C entry's choice of body against its Python mirror;
    then the act and the learn shape timed, beside an empty kernel launch."""
    import importlib

    from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    # The module: the package's attribute of that name is the function.
    fm = importlib.import_module("pearl_tpu_torch.ops.fused_mlp")
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", fm.H100_SMEM_OPTIN)
    switch = fm.ROWS_PER_SM * sms
    shapes = CHECK_SHAPES + [(switch, ACT_SHAPE[1]), (switch + 1, ACT_SHAPE[1]),
                             (switch + 1, WIDE_DIMS)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    timing = {}
    seen = set()
    for B, dims in shapes:
        body = fm.pick_body(B, dims, sms, optin)
        assert body == fm.kernel_pick(B, dims, sms, optin), (B, dims, body)
        seen.add(body)
        x, wb = mlp_operands(B, dims, gen)
        before = dict(fused_mlp.launches_by_body)
        y = fused_mlp(x, *wb)
        torch.cuda.synchronize()
        after = fused_mlp.launches_by_body
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == body) for k in after}, (B, dims, body, before, after)
        ref = fused_mlp_reference(x, wb)
        # f32 both ways; the sums run in another order: rtol/atol 1e-5.
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
        err = (y - ref).abs().max().item()
        max_err = max(max_err, err)

        # The backward pass is the plain chain on both sides; only its seed 2y
        # differs. A weight gradient is a sum over the B rows of terms of both
        # signs, so at a large B the forward's last-bit differences add up to
        # more than 1e-4 of a cancelling sum: the new large shapes hold the
        # forward alone, the two main-path shapes keep their gradient check.
        grads = (B, dims) in (ACT_SHAPE, LEARN_SHAPE) or B <= 2048
        if grads:
            leaves = [t.clone().requires_grad_() for t in (x, *wb)]
            (fused_mlp(*leaves) ** 2).sum().backward()
            ref_leaves = [t.clone().requires_grad_() for t in (x, *wb)]
            (fused_mlp_reference(ref_leaves[0], ref_leaves[1:]) ** 2).sum().backward()
            torch.cuda.synchronize()
            for a, b in zip(leaves, ref_leaves):
                # Gradients of sum(y^2) scale with the forward difference: 1e-4.
                torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)
        print(f"fused_mlp B={B} dims={dims} body={body}: max_abs_err={err:.3e} "
              f"forward{'+grads' if grads else ''} ok", flush=True)

        if (B, dims) in (ACT_SHAPE, LEARN_SHAPE):
            ms = device_ms(lambda: fused_mlp(x, *wb))
            plain_ms = device_ms(lambda: fused_mlp_reference(x, wb))
            bound_ms, bound_by = mlp_bound_ms(B, dims)
            timing[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             body=body)
            print(
                f"fused_mlp B={B} dims={dims} body={body}: kernel {ms:.4f} ms, plain version "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {card}",
                flush=True,
            )
    assert seen == set(fm.BODIES), seen
    assert timing[ACT_SHAPE[0]]["body"] == "tiled" and timing[LEARN_SHAPE[0]]["body"] == "rows"
    empty_ms = device_ms(fm.empty_launch)
    timing[LEARN_SHAPE[0]]["empty_launch_ms"] = empty_ms
    print(f"an empty kernel launch: {empty_ms:.4f} ms on {card} (the floor under the learn "
          f"shape's time, which its operation bound cannot say)", flush=True)
    # What the FMA pipes give at best, at about the act shape's work (two
    # blocks an SM, 1.1 GFLOP) and at eight times that.
    probe_out = torch.empty(2 * sms * 128, device="cuda")
    for iters in (128, 1024):
        flop = fm.fma_probe(probe_out, 2 * sms, iters)
        probe_ms = device_ms(lambda: fm.fma_probe(probe_out, 2 * sms, iters))
        rate = flop / (probe_ms - empty_ms) / 1e9
        timing[ACT_SHAPE[0]][f"fma_probe_{iters}_tflops"] = rate
        print(f"FMA probe, {flop / 1e9:.2f} GFLOP in registers: {probe_ms:.4f} ms, "
              f"{rate:.1f} TFLOP/s net of an empty launch (published peak "
              f"{FP32_FLOP_PER_S / 1e12:.0f}) on {card}", flush=True)
    return max_err, timing


def run_runner(card):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    num_envs, steps_per_learn, learns_per_call, rounds, calls = 131_072, 8, 64, 1, 5
    capacity = 2_097_152
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=rounds, batch_size=1024
        ),
        replay_buffer=BasicReplayBuffer(capacity=capacity),
    )
    init_fn, run_fn = make_compiled_runner(
        agent, CartPole(), num_envs=num_envs,
        steps_per_learn=steps_per_learn, learns_per_call=learns_per_call,
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cuda")
    # Per call: one act launch per env step, and per learn round the online
    # Q (with grad) and the target Q.
    per_call = steps_per_learn * learns_per_call + learns_per_call * rounds * 2
    steps_per_call = steps_per_learn * learns_per_call
    torch.cuda.reset_peak_memory_stats()

    fused_mlp.launches = 0
    fused_mlp.launches_by_body = dict.fromkeys(fused_mlp.launches_by_body, 0)
    t0 = time.perf_counter()
    astate, env_states, stats = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    print(f"runner warm-up call: {time.perf_counter() - t0:.3f} s", flush=True)
    assert fused_mlp.launches == per_call, (fused_mlp.launches, per_call)
    t0 = time.perf_counter()
    for c in range(calls):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        assert fused_mlp.launches == per_call * (c + 2), (fused_mlp.launches, c)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fused_mlp.launches
    # Every act launch (B = 131072) took the tiled body, every learn launch
    # (B = 1024) the rows body; none the first design's.
    by_body = dict(fused_mlp.launches_by_body)
    assert by_body == {
        "tiled": steps_per_call * (calls + 1), "rows": learns_per_call * rounds * 2 * (calls + 1),
        "general": 0,
    }, by_body

    reward_sum, episodes = stats["reward_sum"].item(), stats["episodes"].item()
    assert math.isfinite(reward_sum) and reward_sum == steps_per_call * num_envs, reward_sum
    assert episodes > 0, episodes
    pushed = steps_per_call * num_envs * (calls + 1)
    assert astate.replay.size == min(pushed, capacity), (astate.replay.size, pushed)
    assert astate.replay.cursor == pushed % capacity, (astate.replay.cursor, pushed)
    q = astate.learner.params(astate.history_carry)
    assert q.shape == (num_envs, 2) and torch.isfinite(q).all()
    sps = calls * steps_per_call * num_envs / elapsed
    print(
        f"runner: {sps:.1f} env-steps/s over {calls} calls ({elapsed:.3f} s), "
        f"{launches} fused_mlp launches ({per_call} per call, by body {by_body}), last call "
        f"reward_sum={reward_sum:.0f} episodes={episodes}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    profile_call(run_fn, astate, env_states, gen, elapsed / calls)
    return launches, by_body


def profile_call(run_fn, astate, env_states, gen, wall_s):
    """Device time of one more runner call, by kernel, from torch.profiler;
    set against the unprofiled wall time of a call it gives the card's idle
    share. Outside the launch count: the count is read before this call."""
    return profile_fn(lambda: run_fn(astate, env_states, gen), wall_s)


def profile_fn(fn, wall_s, unit="runner call"):
    """Device time of one `fn()` by kernel, set against `wall_s`, the
    unprofiled wall time of one `fn()`: the card's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    n_device = 0
    for evt in prof.events():
        # Kernels and copies only: user annotations (Optimizer.step, ...)
        # span kernels already counted.
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
            n_device += 1
    busy_s = sum(by_name.values()) / 1e6
    if busy_s == 0:
        print("profile: the profiler saw no device time (idle share not measured)")
        return None
    print(
        f"profile: device busy {busy_s * 1e3:.3f} ms per {unit} in {n_device} "
        f"kernels and copies, unprofiled wall {wall_s * 1e3:.3f} ms per {unit}, "
        f"idle share {1 - busy_s / wall_s:.4f}",
        flush=True,
    )
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # The twelve largest, and the port's own two redesigned kernels wherever they rank.
    shown = ranked[:12] + [kv for kv in ranked[12:] if "fused_mlp" in kv[0] or "ring_conv1" in kv[0]]
    for name, us in shown:
        print(f"profile:   {us / 1e3:10.3f} ms  {100 * us / 1e6 / busy_s:5.1f}%  {name[:90]}")
    return {"busy_ms": busy_s * 1e3, "wall_ms": wall_s * 1e3, "idle_share": 1 - busy_s / wall_s,
            "device_kernels": n_device}


def device_kernels(fn):
    """Kernels and copies the card ran for `fn()`, counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for evt in prof.events()
               if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation)


def run_learning(card):
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=4, batch_size=128,
            exploration=EGreedyExploration(epsilon=0.05),
        ),
        replay_buffer=BasicReplayBuffer(capacity=10_000),
    )
    fused_mlp.launches = 0
    res = online_learning(
        agent, CartPole(), num_envs=16, max_steps=250_000, learn_every_k_steps=2,
        learning_starts=500, seed=42, target_return=500.0, target_window=20,
    )
    last = float(np.mean(res.episode_returns[-20:])) if len(res.episode_returns) else 0.0
    print(
        f"learning: reached_target={res.reached_target} after {res.total_steps} env "
        f"steps, {len(res.episode_returns)} episodes, last-20 mean return {last:.1f}, "
        f"{fused_mlp.launches} fused_mlp launches on {card}",
        flush=True,
    )
    assert res.reached_target, "online_learning did not reach CartPole return 500"
    assert fused_mlp.launches > 0


# The visual workload's shapes: 1024 envs, a window of 4 frames of 84 x 84.
VIS_B, VIS_T, VIS_H, VIS_W = 1_024, 4, 84, 84
VIS_F = VIS_H * VIS_W
VIS_LEARN_B = 512
VIS_C = 4  # channels per frame on the 4-channel path (the env's default)
# Ragged shapes: rows of 301 elements are 602 bytes in bfloat16 (2-byte words
# only) and 1204 in float32 (4-byte words); 300 gives 8-byte words in bfloat16.
RAGGED = [(37, 3, 301), (37, 1, 300), (5, 4, 7), (1, 2, 1)]


def bytes_bound_ms(nbytes):
    return 1e3 * nbytes / HBM_BYTES_PER_S


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _frames(shape, dtype, gen):
    return (torch.rand(shape, device="cuda", generator=gen) * 255.0).to(dtype)


def check_visual_kernels(card):
    """B2, B7, B3, B6a and B6b against their plain versions on the card:
    bit-exact for the copies, exact for the fences (the same float32
    expression and rounding), in float32 and bfloat16, at the shapes of the
    1-channel and the 4-channel path and at ragged ones; then each timed at
    the shape its path gives it."""
    from pearl_tpu_torch.ops.layout_fence import (
        copy_fence, copy_fence_reference, masked_scale_fence, masked_scale_fence4,
        masked_scale_fence4_reference, masked_scale_fence_reference,
    )
    from pearl_tpu_torch.ops.ring_write import (
        ring_write, ring_write_reference, ring_write_where, ring_write_where_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = dict.fromkeys(
        ("ring_write", "ring_write_where", "copy_fence", "masked_scale_fence",
         "masked_scale_fence4"), 0.0)

    def exact(name, got, want):
        assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
        diff = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
        err[name] = max(err[name], diff)
        assert torch.equal(_bits(got), _bits(want)), f"{name}: differs, max abs {diff:.3e}"

    # Both paths' rings (1- and 4-channel frames), then the ragged shapes.
    shapes = [(VIS_B, VIS_T, VIS_F), (VIS_B, VIS_T, VIS_C * VIS_F)] + RAGGED
    # The fences also see the learn batch's sampled windows.
    learn_shapes = [(VIS_LEARN_B, VIS_T, VIS_F), (VIS_LEARN_B, VIS_T, VIS_C * VIS_F)]

    def library_fence(ring, valid, div):
        """One PyTorch call for the fences' function: the mask is 0 or 1, so
        (x * m) * inv equals x * (m * inv) bit for bit, and the (B, T) scale
        is prepared once outside the call. Used here only."""
        inv = torch.tensor(1.0 / div, dtype=torch.float32).item()
        scale = (valid.to(torch.float32) * inv)[..., None]
        out = torch.empty_like(ring)
        return (lambda: torch.mul(ring, scale, out=out)), out

    for dtype in (torch.float32, torch.bfloat16):
        for B, T, F in shapes + learn_shapes:
            if (B, T, F) in learn_shapes:
                cursors = ()  # the fences only
            else:
                cursors = range(T) if B != VIS_B else (0, T - 1)
            for c in cursors:
                ring = _frames((B, T, F), dtype, gen)
                entry, reset = _frames((B, F), dtype, gen), _frames((B, F), dtype, gen)
                done = torch.rand((B,), device="cuda", generator=gen) < 0.3
                # B2: the written slab and the untouched T-1 slots alike.
                got = ring_write(ring.clone(), entry, c)
                exact("ring_write", got, ring_write_reference(ring.clone(), entry, c))
                # B2 from a strided source (the rows of a wider matrix).
                wide = _frames((B, 2 * F + 8), dtype, gen)
                got = ring_write(ring.clone(), wide[:, 8 : 8 + F], c)
                exact("ring_write", got, ring_write_reference(ring.clone(), wide[:, 8 : 8 + F], c))
                # B7.
                got = ring_write_where(ring.clone(), entry, reset, done, c)
                exact("ring_write_where", got,
                      ring_write_where_reference(ring.clone(), entry, reset, done, c))
                # B3: the strided newest-frame view of the ring.
                exact("copy_fence", copy_fence(ring[:, c]), copy_fence_reference(ring[:, c]))
            ring = _frames((B, T, F), dtype, gen)
            valid = torch.rand((B, T), device="cuda", generator=gen) < 0.7
            for div in (255.0, 1.0):
                exact("masked_scale_fence", masked_scale_fence(ring, valid, div),
                      masked_scale_fence_reference(ring, valid, div))
                H, W = (VIS_H, F // VIS_H) if F % VIS_F == 0 else (1, F)
                got4 = masked_scale_fence4(ring, valid, H=H, W=W, div=div)
                exact("masked_scale_fence4", got4,
                      masked_scale_fence4_reference(ring, valid, H=H, W=W, div=div))
                call, out = library_fence(ring, valid, div)
                call()
                exact("masked_scale_fence", out, masked_scale_fence(ring, valid, div))
                exact("masked_scale_fence4", out.view(got4.shape), got4)
        # copy_fence of another element size.
        x = torch.randint(0, 255, (37, 2 * 301), device="cuda", generator=gen).to(torch.uint8)
        assert torch.equal(copy_fence(x[:, 3:304]), x[:, 3:304])
        torch.cuda.synchronize()
        print(f"visual kernels {dtype}: B2, B7, B3 bit-exact at {len(shapes)} shapes, B6a, B6b "
              f"exact at {len(shapes) + len(learn_shapes)} shapes (and equal to the one-call "
              f"library form)", flush=True)

    # Timing at the shapes of the main path, operands cold in the L2 cache.
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    ring = _frames((VIS_B, VIS_T, VIS_F), bf16, gen)
    valid = torch.rand((VIS_B, VIS_T), device="cuda", generator=gen) < 0.7
    obs, reset = _frames((VIS_B, VIS_F), bf16, gen), _frames((VIS_B, VIS_F), bf16, gen)
    done = torch.rand((VIS_B,), device="cuda", generator=gen) < 0.3
    learn_ring = _frames((VIS_LEARN_B, VIS_T, VIS_F), torch.float32, gen)
    learn_valid = torch.ones((VIS_LEARN_B, VIS_T), dtype=torch.bool, device="cuda")
    # The 4-channel path's windows, the shapes `masked_scale_fence` is given.
    ring_c = _frames((VIS_B, VIS_T, VIS_C * VIS_F), bf16, gen)
    learn_ring_c = _frames((VIS_LEARN_B, VIS_T, VIS_C * VIS_F), torch.float32, gen)
    c = 2
    frame_bytes = VIS_B * VIS_F * 2

    def ms(fn):
        return device_ms(fn, flush=flush)

    def fence_times(kernel, plain, ring, valid):
        return dict(
            ms=ms(kernel), plain_ms=ms(plain),
            library_ms=ms(library_fence(ring, valid, 255.0)[0]),
            bound_ms=bytes_bound_ms(2 * ring.numel() * ring.element_size() + valid.numel()),
        )

    timing = {
        "ring_write": dict(
            ms=ms(lambda: ring_write(ring, obs, c)),
            plain_ms=ms(lambda: ring_write_reference(ring, obs, c)),
            library_ms=ms(lambda: ring[:, c].copy_(obs)),
            bound_ms=bytes_bound_ms(2 * frame_bytes),
        ),
        # The select reads, per row, only the source it picks: one frame in,
        # one frame out, and the done bytes.
        "ring_write_where": dict(
            ms=ms(lambda: ring_write_where(ring, obs, reset, done, c)),
            plain_ms=ms(lambda: ring_write_where_reference(ring, obs, reset, done, c)),
            library_ms=ms(lambda: torch.where(done[:, None], reset, obs, out=ring[:, c])),
            bound_ms=bytes_bound_ms(2 * frame_bytes + VIS_B),
            where_then_ring_write_ms=ms(
                lambda: ring_write(ring, torch.where(done[:, None], reset, obs), c)),
        ),
        "copy_fence": dict(
            ms=ms(lambda: copy_fence(ring[:, c])),
            plain_ms=ms(lambda: copy_fence_reference(ring[:, c])),
            library_ms=ms(lambda: ring[:, c].contiguous()),
            bound_ms=bytes_bound_ms(2 * frame_bytes),
        ),
        # B6a at the 4-channel path's shapes: act (1024, 4, 28224) bfloat16,
        # learn (512, 4, 28224) float32.
        "masked_scale_fence": dict(
            **fence_times(
                lambda: masked_scale_fence(ring_c, valid, 255.0),
                lambda: masked_scale_fence_reference(ring_c, valid, 255.0), ring_c, valid),
            learn_shape=fence_times(
                lambda: masked_scale_fence(learn_ring_c, learn_valid, 255.0),
                lambda: masked_scale_fence_reference(learn_ring_c, learn_valid, 255.0),
                learn_ring_c, learn_valid),
        ),
        # B6b at the 1-channel path's: (1024, 4, 7056) bfloat16, (512, 4, 7056) float32.
        "masked_scale_fence4": dict(
            **fence_times(
                lambda: masked_scale_fence4(ring, valid, H=VIS_H, W=VIS_W),
                lambda: masked_scale_fence4_reference(ring, valid, H=VIS_H, W=VIS_W), ring, valid),
            learn_shape=fence_times(
                lambda: masked_scale_fence4(learn_ring, learn_valid, H=VIS_H, W=VIS_W),
                lambda: masked_scale_fence4_reference(learn_ring, learn_valid, H=VIS_H, W=VIS_W),
                learn_ring, learn_valid),
        ),
    }
    for name, t in timing.items():
        t["bound_by"] = "bytes"
        t["max_abs_err"] = err[name]
        F = VIS_C * VIS_F if name == "masked_scale_fence" else VIS_F
        rows = [(f"B={VIS_B} T={VIS_T} F={F} bfloat16", t)]
        if "learn_shape" in t:
            rows.append((f"B={VIS_LEARN_B} T={VIS_T} F={F} float32", t["learn_shape"]))
        for shape, r in rows:
            print(
                f"{name} {shape}: kernel {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, "
                f"library call {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes) "
                f"on {card}",
                flush=True,
            )
    t = timing["ring_write_where"]
    print(f"ring_write_where against torch.where then ring_write: {t['ms']:.4f} ms vs "
          f"{t['where_then_ring_write_ms']:.4f} ms on {card}", flush=True)
    return timing

# conv1 of the visual workload: 8 x 8 stride 4 to 16 channels, 20 x 20 outputs.
VIS_K, VIS_S, VIS_OC, VIS_OH = 8, 4, 16, 20
# B4's ragged shapes (B, T, OC, OH, OW): chunks of 75 and 7 elements move in
# 2- and 4-byte words, T = 1 is the one-slot ring.
CACHE_RAGGED = [(37, 3, 16, 4, 4), (5, 4, 3, 5, 5), (1, 1, 16, 4, 4), (37, 2, 1, 7, 1)]
# B5's small and odd shapes (B, T, H, W, k, s, OC): the reference's two test
# geometries, k == s, and a frame whose bands are not 16-byte aligned.
CONV_SMALL = [
    (37, 4, 20, 20, 8, 4, 16), (37, 3, 28, 28, 8, 4, 8), (1, 1, 20, 20, 4, 4, 16),
    (5, 2, 28, 28, 4, 2, 32), (3, 4, 21, 19, 5, 3, 4),
    # More for the tensor-core body (bfloat16): one env at the bench geometry,
    # two blocks of 8 kx (k = 16) to 32 channels, a frame that is not square,
    # and more envs than resident blocks with one stage to spare.
    (1, 4, 84, 84, 8, 4, 16), (5, 2, 36, 36, 16, 4, 32), (9, 3, 32, 28, 8, 4, 8),
    (700, 2, 84, 84, 8, 4, 16),
]


def check_act_kernels(card):
    """B4 `cache_write` and B5 `ring_conv1` against their plain versions on
    the card, in float32 and bfloat16, at the shapes of the visual workload
    and at ragged ones; then each timed at the shape its path gives it, with
    `gather_sum` and what `ring_conv1` replaces on the act path beside them."""
    import torch.nn.functional as F

    from pearl_tpu_torch.ops.conv_cache import cache_write, cache_write_reference, gather_sum
    from pearl_tpu_torch.ops.layout_fence import masked_scale_fence4
    from pearl_tpu_torch.ops import ring_conv as rc
    from pearl_tpu_torch.ops.ring_conv import ring_conv1, ring_conv1_reference

    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {"cache_write": 0.0, "ring_conv1": 0.0}

    def rand(shape, dtype):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    # B4: bit-exact, the T written slabs and the untouched ones alike.
    bench4 = (VIS_B, VIS_T, VIS_OC, VIS_OH, VIS_OH)
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, OC, OH, OW in [bench4] + CACHE_RAGGED:
            D = OC * OH * OW
            for c in range(T) if B != VIS_B else (0, T - 1):
                cache = rand((T, T, B, D), dtype)
                y = rand((B, T * OC, OH, OW), dtype)
                # y as it comes from the conv, and as a channel slice of a
                # wider tensor (another row stride, an odd base address).
                wide = rand((B, T * OC + 2, OH, OW), dtype)
                for src in (y, wide[:, 1 : 1 + T * OC]):
                    got = cache_write(cache.clone(), src, c, T=T, OC=OC)
                    want = cache_write_reference(cache.clone(), src, c, T=T, OC=OC)
                    assert torch.equal(_bits(got), _bits(want)), (
                        f"cache_write differs at {(B, T, OC, OH, OW)} {dtype} cursor {c}")
        torch.cuda.synchronize()
        print(f"cache_write {dtype}: bit-exact at {1 + len(CACHE_RAGGED)} shapes, every "
              f"cursor, contiguous and sliced sources", flush=True)

    # B5: float32 sums in another order, rtol/atol 2e-5; in bfloat16 the one
    # rounding of the output may fall the other way: one ulp, rtol 2^-7.
    tol = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2**-7, atol=2e-5)}
    bench5 = (VIS_B, VIS_T, VIS_H, VIS_W, VIS_K, VIS_S, VIS_OC)

    def conv_operands(B, T, H, W, k, s, OC, dtype):
        ring = _frames((B, T, H * W), dtype, gen)
        valid = torch.rand((B, T), device="cuda", generator=gen) < 0.7
        valid[0] = False  # an env with no valid frame: bias and relu alone
        if B > 1:
            valid[1] = True
        wmat = torch.randn((T * k * k, OC), device="cuda", generator=gen) * (0.1 / 255.0)
        bias = torch.randn((OC,), device="cuda", generator=gen) * 0.1
        return ring, valid, wmat, bias

    def hold(ring, valid, wmat, bias, H, W, k, s, body):
        """One launch against the plain version; the body it took."""
        B, T, OC, dtype = ring.shape[0], ring.shape[1], wmat.shape[1], ring.dtype
        before = (ring_conv1.launches, ring_conv1.mma_launches)
        got = ring_conv1(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)
        torch.cuda.synchronize()
        assert (ring_conv1.launches, ring_conv1.mma_launches) == (
            before[0] + 1, before[1] + (body == "mma")), (ring.shape, dtype, body)
        want = ring_conv1_reference(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)
        OH, OW = (H - k) // s + 1, (W - k) // s + 1
        assert got.shape == want.shape == (B, OC, OH, OW) and got.dtype == dtype
        assert got.is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), **tol[dtype])
        err["ring_conv1"] = max(err["ring_conv1"], (got.float() - want.float()).abs().max().item())
        return got

    bodies = {dtype: [] for dtype in tol}
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, W, k, s, OC in [bench5] + CONV_SMALL:
            body = rc.pick_body(dtype, T, H, W, k, s, OC)
            assert body == rc.kernel_pick(dtype, T, H, W, k, s, OC), (dtype, T, H, W, k, s, OC)
            bodies[dtype].append(body)
            ring, valid, wmat, bias = conv_operands(B, T, H, W, k, s, OC, dtype)
            got = hold(ring, valid, wmat, bias, H, W, k, s, body)
            # Not trivially: about half the sums are positive before the relu,
            # and the env with no valid frame holds relu(bias) alone.
            assert 0.2 < (got[1:] > 0).float().mean().item() < 0.8 or B == 1
            assert torch.equal(got[0].float().amax((1, 2)), torch.relu(bias).to(dtype).float())
            # wmat as the network hands it over: rolled by a cursor along the
            # frame axis (a copy of a rolled view), and every frame valid.
            rolled = torch.roll(wmat.view(T, k * k, OC), 1, 0).reshape(T * k * k, OC)
            hold(ring, torch.ones_like(valid), rolled, bias, H, W, k, s, body)
            if B > 1:
                # A ring whose base is not 16-byte aligned: a view from the second
                # env of a float32 ring starts 4 bytes off only when a frame is odd;
                # from inside a wider buffer it starts 2 or 4 bytes off always.
                flat = torch.empty(ring.numel() + 1, dtype=dtype, device="cuda")
                off = flat[1:].view(ring.shape).copy_(ring)
                assert off.data_ptr() % 16 != 0 and off.is_contiguous()
                hold(off, valid, wmat, bias, H, W, k, s, "general")
        print(f"ring_conv1 {dtype}: within rtol {tol[dtype]['rtol']:.3e} atol "
              f"{tol[dtype]['atol']:.0e} of the plain version at {1 + len(CONV_SMALL)} shapes "
              f"(bodies {bodies[dtype]}; a rolled wmat with every frame valid and an unaligned "
              f"ring at each), max abs err so far {err['ring_conv1']:.3e}", flush=True)
    assert set(bodies[torch.float32]) == {"general"}
    assert bodies[torch.bfloat16].count("mma") == 7 and bodies[torch.bfloat16][0] == "mma"

    # Timing at the shapes of the main paths, operands cold in the L2 cache.
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16

    def ms(fn):
        return device_ms(fn, flush=flush)

    B, T, OC, OH, OW = bench4
    D = OC * OH * OW
    cache = rand((T, T, B, D), bf16)
    y = rand((B, T * OC, OH, OW), bf16)
    c = 2
    rows = torch.tensor([(c - p) % T for p in range(T)], device="cuda")
    cols = torch.arange(T, device="cuda")
    chunks = y.view(B, T, D).permute(1, 0, 2)  # (T, B, D): chunk p of every row
    cache_bytes = 2 * B * T * D * 2
    timing = {"cache_write": dict(
        ms=ms(lambda: cache_write(cache, y, c, T=T, OC=OC)),
        plain_ms=ms(lambda: cache_write_reference(cache, y, c, T=T, OC=OC)),
        library_ms=ms(lambda: cache.index_put_((rows, cols), chunks)),
        bound_ms=bytes_bound_ms(cache_bytes), bound_by="bytes",
        max_abs_err=err["cache_write"],
    )}
    want = cache_write_reference(cache.clone(), y, c, T=T, OC=OC)
    assert torch.equal(_bits(cache.clone().index_put_((rows, cols), chunks)), _bits(want))
    valid4 = torch.rand((B, T), device="cuda", generator=gen) < 0.7
    gather_ms = ms(lambda: gather_sum(cache, valid4, c))

    ring, valid, wmat32, bias = conv_operands(*bench5, bf16)
    # The weights as the network hands them over: in the ring's dtype.
    wmat = wmat32.to(bf16)
    n_valid = int(valid.sum().item())
    # This run's data: only valid frames are read and multiplied.
    conv_bytes = (n_valid * VIS_F * 2 + valid.numel() + wmat.numel() * 2 + bias.numel() * 4
                  + B * OC * OH * OW * 2)
    conv_flops = 2 * n_valid * OH * OW * OC * VIS_K * VIS_K
    t_bytes, t_ops = conv_bytes / HBM_BYTES_PER_S, conv_flops / BF16_FLOP_PER_S
    w4 = (wmat32 * 255.0).to(bf16).reshape(T, VIS_K, VIS_K, OC).permute(3, 0, 1, 2).contiguous()
    b16 = bias.to(bf16)

    def replaced():
        inp = masked_scale_fence4(ring, valid, H=VIS_H, W=VIS_W, div=255.0)
        return F.relu(F.conv2d(inp, w4, b16, stride=VIS_S))

    timing["ring_conv1"] = dict(
        ms=ms(lambda: ring_conv1(ring, valid, wmat, bias, H=VIS_H, W=VIS_W, k=VIS_K, s=VIS_S)),
        plain_ms=ms(lambda: ring_conv1_reference(
            ring, valid, wmat, bias, H=VIS_H, W=VIS_W, k=VIS_K, s=VIS_S)),
        library_ms=None,
        bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        max_abs_err=err["ring_conv1"],
        fence4_conv2d_relu_ms=ms(replaced),
        valid_frames=n_valid,
        body=rc.pick_body(bf16, *bench5[1:]),
    )
    # Every frame valid, as on the runner's path after its first steps.
    all_valid = torch.ones_like(valid)
    full_bytes = conv_bytes + (valid.numel() - n_valid) * VIS_F * 2
    timing["ring_conv1"]["all_valid"] = dict(
        ms=ms(lambda: ring_conv1(ring, all_valid, wmat, bias, H=VIS_H, W=VIS_W, k=VIS_K, s=VIS_S)),
        bound_ms=bytes_bound_ms(full_bytes), bound_by="bytes",
    )
    # The same kernel on a float32 ring, bound by its float32 operations.
    ring32, wmat = ring.float(), wmat32
    f32_bytes = conv_bytes + n_valid * VIS_F * 2 + wmat.numel() * 2 + B * OC * OH * OW * 2
    t_bytes, t_ops = f32_bytes / HBM_BYTES_PER_S, conv_flops / FP32_FLOP_PER_S
    timing["ring_conv1"]["float32_shape"] = dict(
        ms=ms(lambda: ring_conv1(ring32, valid, wmat, bias, H=VIS_H, W=VIS_W, k=VIS_K, s=VIS_S)),
        bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )

    t = timing["cache_write"]
    print(f"cache_write B={B} T={T} D={D} bfloat16: kernel {t['ms']:.4f} ms, plain version (T "
          f"copy_ calls) {t['plain_ms']:.4f} ms, library call (one index_put_) "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes) on {card}", flush=True)
    print(f"gather_sum (plain PyTorch, no kernel) cache ({T}, {T}, {B}, {D}) bfloat16: "
          f"{gather_ms:.4f} ms on {card}", flush=True)
    t = timing["ring_conv1"]
    print(f"ring_conv1 B={B} T={T} {VIS_H}x{VIS_W} k={VIS_K} s={VIS_S} OC={OC} bfloat16 "
          f"(body {t['body']}), {n_valid} of {B * T} frames valid: kernel {t['ms']:.4f} ms, plain version "
          f"{t['plain_ms']:.4f} ms, library call none, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); what it replaces on the act path (masked_scale_fence4 + "
          f"F.conv2d with bias + relu, bfloat16) {t['fence4_conv2d_relu_ms']:.4f} ms on {card}",
          flush=True)
    print(f"ring_conv1 the same shape, every frame valid: kernel {t['all_valid']['ms']:.4f} ms, "
          f"bound {t['all_valid']['bound_ms']:.4f} ms (bytes) on {card}", flush=True)
    t = t["float32_shape"]
    print(f"ring_conv1 the same shape float32 (general body): kernel {t['ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}", flush=True)
    return timing


def visual_wrappers():
    from pearl_tpu_torch.ops.layout_fence import (
        copy_fence, masked_scale_fence, masked_scale_fence4,
    )
    from pearl_tpu_torch.ops.conv_cache import cache_write
    from pearl_tpu_torch.ops.ring_conv import ring_conv1
    from pearl_tpu_torch.ops.ring_write import ring_write, ring_write_where

    return {
        "ring_write": ring_write, "ring_write_where": ring_write_where,
        "copy_fence": copy_fence, "masked_scale_fence": masked_scale_fence,
        "masked_scale_fence4": masked_scale_fence4, "cache_write": cache_write,
        "ring_conv1": ring_conv1,
    }


def visual_agent(num_envs, frames, batch_size, **net_options):
    """The CNN-DQN composition of the reference's visual workload, with
    `frames` channels per frame; `net_options` select an opt-in act path of
    the network (`conv1_cache=True` or `ring_conv=True`)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import SyntheticAtari
    from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
    from pearl_tpu_torch.neural_networks import CNNQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import VisualReplayBuffer

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(
                input_shape=(VIS_H, VIS_W, VIS_T * frames), time_major_stack=True,
                frame_channels=frames, **net_options,
            ),
            training_rounds=1, batch_size=batch_size, act_dtype="bfloat16",
            history_summarizer=FrameRingHistorySummarization(
                history_length=VIS_T, dtype=torch.bfloat16),
        ),
        replay_buffer=VisualReplayBuffer(
            capacity=8 * num_envs, stack=VIS_T, num_envs=num_envs,
            frame_dtype=torch.bfloat16, dedup_next=True,
        ),
    )
    return agent, SyntheticAtari(frames=frames, obs_dtype=torch.bfloat16)


def check_visual_state(agent, env, astate, num_envs, steps):
    """The bookkeeping and the values after `steps` env steps from init."""
    from pearl_tpu_torch.history_summarization_modules import FrameRingView

    replay, view = astate.replay, astate.history_carry
    capacity = 8 * num_envs
    assert replay.push_count == steps, (replay.push_count, steps)
    assert replay.size == min(steps * num_envs, capacity), replay.size
    assert replay.cursor == (steps % 8) * num_envs, replay.cursor
    assert view.cursor == (1 + steps) % VIS_T, view.cursor
    # Every env truncates at the same step, so after `steps` steps each has
    # written this many frames of its current episode.
    in_episode = steps % env.episode_len + 1
    want = torch.zeros((VIS_T,), dtype=torch.bool)
    for back in range(min(VIS_T, in_episode)):
        want[(view.cursor - 1 - back) % VIS_T] = True
    assert torch.equal(view.valid.cpu(), want[None].expand(num_envs, VIS_T)), view.valid[0]
    assert view.ring.dtype == torch.bfloat16 and torch.isfinite(view.ring.float()).all()

    bound = agent.for_env(env)
    learner = bound.policy_learner
    with torch.no_grad():
        q = learner._scores(astate.learner, bound.subjective_state(astate), None)
    assert q.shape == (num_envs, 6) and q.dtype == torch.float32 and torch.isfinite(q).all()

    # Against the plain path: 8 envs' window in float32 through the kernels
    # on the card and through the plain version on the CPU (the package
    # switches TF32 off on import, so both are full float32).
    import copy

    net = learner.q_network
    cached = view.cache is not None
    small = FrameRingView(view.ring[:8].float().contiguous(), view.valid[:8].clone(), view.cursor)
    with torch.no_grad():
        if cached:  # the small window's own cache, through copy_fence and cache_write
            small.cache = net.refresh_cache(astate.learner.params, small)
        on_card = net.q_all(astate.learner.params, small, None)
        cpu_view = FrameRingView(small.ring.cpu(), small.valid.cpu(), small.cursor)
        cpu_params = copy.deepcopy(astate.learner.params).cpu()
        if cached:
            cpu_view.cache = net.refresh_cache(cpu_params, cpu_view)
        on_cpu = net.q_all(cpu_params, cpu_view, None)
        # The default branch on the CPU (fences and the window conv).
        direct = dataclasses.replace(net, conv1_cache=False, ring_conv=False)
        on_cpu_direct = direct.q_all(cpu_params, dataclasses.replace(cpu_view, cache=None), None)
    # float32 both ways; cuDNN, the kernels and the CPU sum conv taps in other
    # orders (1e-4); the cached path groups its sum by frame (2e-4).
    tol = 2e-4 if cached else 1e-4
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=tol, atol=tol)
    torch.testing.assert_close(on_card.cpu(), on_cpu_direct, rtol=tol, atol=tol)
    return q


def check_incremental_cache(agent, env, astate, env_states, gen, num_envs):
    """Three more env steps without a learn, at full width, so that the live
    cache holds three per-step `cache_write`s on top of the last refresh:
    it must equal a from-scratch `refresh_cache` with the same weights (the
    same convolution of the same frames: one bfloat16 ulp at most), and the
    cached Q must agree with the direct Q (bfloat16 forward: 3e-2)."""
    from pearl_tpu_torch.training import make_compiled_runner

    _, step_fn = make_compiled_runner(
        agent, env, num_envs=num_envs, steps_per_learn=3, learns_per_call=1, learn=False)
    astate, env_states, _ = step_fn(astate, env_states, gen)
    bound = agent.for_env(env)
    net, learner = bound.policy_learner.q_network, bound.policy_learner
    view = astate.history_carry
    live = view.cache.clone()
    fresh = net.refresh_cache(astate.learner.params, dataclasses.replace(view, cache=None))
    torch.testing.assert_close(live.float(), fresh.float(), rtol=2**-7, atol=1e-3)
    differing = (live != fresh).sum().item()
    with torch.no_grad():
        q_cached = learner._scores(astate.learner, bound.subjective_state(astate), None)
        q_direct = learner._scores(astate.learner, dataclasses.replace(view, cache=None), None)
    torch.testing.assert_close(q_cached, q_direct, rtol=0, atol=3e-2)
    print(f"incremental cache after 3 steps without a learn: {differing} of {live.numel()} "
          f"elements differ from a from-scratch refresh (within one bfloat16 ulp), cached Q "
          f"within {(q_cached - q_direct).abs().max().item():.3e} of the direct Q", flush=True)
    return astate, env_states


def run_visual_runner(card, frames, calls, conv1_cache=False, ring_conv=False):
    """`make_compiled_runner` on the visual composition at its full width,
    with `frames` channels per frame: one warm-up call, then `calls` timed
    ones. With 1 channel the conv input comes from `masked_scale_fence4`;
    with more it needs a channel interleave after the fence and comes from
    `masked_scale_fence`. `conv1_cache` and `ring_conv` select the network's
    opt-in act paths, which leave the fences to the learn step. Returns the
    launch counts of the whole run and its env-steps/s."""
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    num_envs, steps_per_learn, learns_per_call = VIS_B, 8, 8
    net_options = {k: True for k, on in (("conv1_cache", conv1_cache), ("ring_conv", ring_conv)) if on}
    agent, env = visual_agent(num_envs, frames=frames, batch_size=VIS_LEARN_B, **net_options)
    init_fn, run_fn = make_compiled_runner(
        agent, env, num_envs=num_envs,
        steps_per_learn=steps_per_learn, learns_per_call=learns_per_call,
    )
    wrappers = visual_wrappers()
    steps_per_call = steps_per_learn * learns_per_call
    # Per call: one ring write, one frame copy and one act fence per env
    # step; per learn the online and the target forward's fence.
    fence, other = "masked_scale_fence4", "masked_scale_fence"
    if frames > 1:
        fence, other = other, fence
    per_call = {
        "ring_write": 0, "ring_write_where": steps_per_call, "copy_fence": steps_per_call,
        fence: steps_per_call + 2 * learns_per_call, other: 0, "cache_write": 0, "ring_conv1": 0,
    }
    at_init = {**dict.fromkeys(per_call, 0), "ring_write": 1}  # the init seed
    if conv1_cache or ring_conv:
        per_call[fence] = 2 * learns_per_call  # the act path no longer masks the window
    if conv1_cache:
        # Per env step the entry frame is copied out of the ring and its
        # contributions written; per learn every slot is redone.
        per_call["copy_fence"] += steps_per_call + VIS_T * learns_per_call
        per_call["cache_write"] = steps_per_call + VIS_T * learns_per_call
        at_init.update(copy_fence=VIS_T, cache_write=VIS_T)
    elif ring_conv:
        per_call["ring_conv1"] = steps_per_call
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["ring_conv1"].mma_launches = 0
    torch.cuda.reset_peak_memory_stats()

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    astate, env_states = init_fn(0)
    assert counts() == at_init, counts()
    assert (astate.history_carry.cache is not None) == conv1_cache
    ring = astate.history_carry.ring
    assert ring.shape == (num_envs, VIS_T, frames * VIS_F) and ring.dtype == torch.bfloat16
    gen = make_generator(0, "cuda")
    t0 = time.perf_counter()
    astate, env_states, stats = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    tag = f"visual runner, {frames}-channel frames" + "".join(f", {k}" for k in net_options)
    print(f"{tag}, warm-up call: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    for c in range(calls):
        astate, env_states, stats = run_fn(astate, env_states, gen)
        want = {name: n * (c + 2) + at_init[name] for name, n in per_call.items()}
        assert counts() == want, (counts(), want)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts()
    # Every launch of the ring conv took the tensor-core body.
    assert wrappers["ring_conv1"].mma_launches == launches["ring_conv1"], (
        wrappers["ring_conv1"].mma_launches, launches["ring_conv1"])

    reward_sum, episodes = stats["reward_sum"].item(), stats["episodes"].item()
    assert math.isfinite(reward_sum) and 0 <= reward_sum <= steps_per_call * num_envs, reward_sum
    steps = steps_per_call * (calls + 1)
    assert episodes == num_envs * (steps // 128 - (steps - steps_per_call) // 128), episodes
    q = check_visual_state(agent, env, astate, num_envs, steps)
    astate, metrics = agent.for_env(env).learn(astate, gen)
    loss = metrics["loss"].item()
    assert math.isfinite(loss), loss
    sps = calls * steps_per_call * num_envs / elapsed
    print(
        f"{tag}: {sps:.1f} env-steps/s over {calls} calls ({elapsed:.3f} s), launches "
        f"{launches} ({per_call} per call), last call reward_sum={reward_sum:.0f} "
        f"episodes={episodes}, Q in [{q.min().item():.4f}, {q.max().item():.4f}], loss "
        f"{loss:.6f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    if conv1_cache:
        astate, env_states = check_incremental_cache(agent, env, astate, env_states, gen, num_envs)
    profile_call(run_fn, astate, env_states, gen, elapsed / calls)
    return launches, sps


# Continuous control: the CSAC workload of bench.py:287-312, nothing cut.
CONT_B, CONT_SPL, CONT_LPC = 131_072, 8, 16
CONT_CAPACITY = 16 * CONT_B  # 2_097_152 rows: 16 pushes resident


def continuous_learner(name, **kw):
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        TD3, ContinuousSoftActorCritic, DeepDeterministicPolicyGradient,
    )

    cls = {"csac": ContinuousSoftActorCritic, "ddpg": DeepDeterministicPolicyGradient,
           "td3": TD3}[name]
    return cls(**kw)


def checked_pendulum():
    """Pendulum that counts, on the card, the actions it was given that are
    not finite or lie outside [-max_torque, max_torque], and on the host the
    actions it saw; for the one call of a runner that checks every action
    (the count costs launches)."""
    from pearl_tpu_torch.envs import Pendulum

    @dataclasses.dataclass(frozen=True)
    class CheckedPendulum(Pendulum):
        bad: torch.Tensor = dataclasses.field(
            default_factory=lambda: torch.zeros((), dtype=torch.int64, device="cuda"))
        seen: list = dataclasses.field(default_factory=lambda: [0])

        def step(self, state, action):
            a = action.float()
            self.bad.add_((~torch.isfinite(a) | (a.abs() > self.max_torque)).sum())
            self.seen[0] += a.numel()
            return super().step(state, action)

    return CheckedPendulum()


def run_continuous_runner(card, name, calls):
    """`make_compiled_runner` at the CSAC workload's width with learner
    `name`: a warm-up call through a Pendulum that checks every action, then
    `calls` timed calls, each synchronised and timed on its own. Returns
    (agent, env, runner, state, env-steps/s per timed call)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import Pendulum
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    agent = PearlAgent(
        policy_learner=continuous_learner(name, training_rounds=1, batch_size=1024),
        replay_buffer=BasicReplayBuffer(capacity=CONT_CAPACITY),
    )
    env = Pendulum()
    kw = dict(num_envs=CONT_B, steps_per_learn=CONT_SPL, learns_per_call=CONT_LPC)
    init_fn, run_fn = make_compiled_runner(agent, env, **kw)
    checked = checked_pendulum()
    _, run_checked = make_compiled_runner(agent, checked, **kw)
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cuda")
    steps_per_call = CONT_SPL * CONT_LPC
    fused_before = fused_mlp.launches
    t0 = time.perf_counter()
    astate, env_states, stats = run_checked(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    print(f"{name} runner, warm-up call (every action checked): {time.perf_counter() - t0:.3f} s",
          flush=True)
    assert checked.seen[0] == steps_per_call * CONT_B and checked.bad.item() == 0, (
        checked.seen, checked.bad.item())
    rates = []
    for c in range(calls):
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates.append(steps_per_call * CONT_B / (time.perf_counter() - t0))
        # The actions resident in the replay: the last 16 steps of this call.
        actions = astate.replay.storage.action
        assert torch.isfinite(actions).all() and (actions.abs() <= 2.0).all()
    pushed = steps_per_call * CONT_B * (calls + 1)
    replay = astate.replay
    assert replay.size == min(pushed, CONT_CAPACITY) and replay.cursor == pushed % CONT_CAPACITY, (
        replay.size, replay.cursor, pushed)
    assert (replay.storage.action_index == 0).all()
    assert astate.learner.step == CONT_LPC * (calls + 1), astate.learner.step
    assert fused_mlp.launches == fused_before  # this path reaches no kernel of the port
    reward_sum, episodes = stats["reward_sum"].item(), stats["episodes"].item()
    assert math.isfinite(reward_sum) and reward_sum < 0, reward_sum
    assert episodes == CONT_B * ((calls + 1) * steps_per_call // 200 - (calls * steps_per_call) // 200)
    print(f"{name} runner: env-steps/s per timed call "
          f"{', '.join(f'{r:.1f}' for r in rates)} (median {statistics.median(rates):.1f}); last "
          f"call reward_sum={reward_sum:.1f} episodes={episodes}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
    return agent, env, run_fn, (astate, env_states, gen), rates


def check_learn_metrics(agent, env, astate, gen, name):
    """One more learn: its losses (and SAC's temperature) are finite."""
    astate, metrics = agent.for_env(env).learn(astate, gen)
    values = {k: v.item() for k, v in metrics.items()}
    assert values and all(math.isfinite(v) for v in values.values()), values
    extra = getattr(astate.learner, "extra", None)
    if extra is not None:
        assert math.isfinite(extra.log_alpha.item()), extra.log_alpha
        values["log_alpha"] = extra.log_alpha.item()
    print(f"{name} learn metrics: " + ", ".join(f"{k}={v:.6f}" for k, v in values.items()),
          flush=True)
    return astate


def run_csac_runner(card):
    """The CSAC runner: per-call rates, a profiled call (busy and idle share,
    the top kernels), and the device kernels of one env step and of one
    learn (`kernels_per_step_and_learn`)."""
    agent, env, run_fn, (astate, env_states, gen), rates = run_continuous_runner(card, "csac", 4)
    torch.cuda.synchronize()
    wall_s = CONT_SPL * CONT_LPC * CONT_B / statistics.median(rates)
    prof = profile_call(run_fn, astate, env_states, gen, wall_s)
    per_step, per_learn, step_counts, learn_counts, astate, _ = kernels_per_step_and_learn(
        agent, env, astate, env_states, gen, CONT_B)
    astate = check_learn_metrics(agent, env, astate, gen, "csac")
    per_call = CONT_SPL * CONT_LPC * per_step + CONT_LPC * per_learn
    print(f"csac runner: {per_step:.1f} device kernels per env step (windows of 8 and 72 steps: "
          f"{step_counts}), {per_learn:.1f} per learn (training_rounds=1, batch 1024; windows of "
          f"4 and 20: {learn_counts}), so {per_call:.0f} per call besides the runner's own sums "
          f"(the profiled call: {prof and prof['device_kernels']}) on {card}", flush=True)
    return {"rates": rates, "profile": prof, "kernels_per_step": per_step,
            "kernels_per_learn": per_learn}


def run_ddpg_td3_runners(card):
    """DDPG and TD3 at the CSAC workload's width, a warm-up and a timed call
    each; then TD3's delay gate: over two more learns the actor and its
    target stay exactly as they were on the closed step and move on the
    open one."""
    out = {}
    for name in ("ddpg", "td3"):
        agent, env, _, (astate, _, gen), rates = run_continuous_runner(card, name, 1)
        astate = check_learn_metrics(agent, env, astate, gen, name)
        out[name] = rates[0]
    bound = agent.for_env(env)
    gates = []
    for _ in range(2):
        learner = astate.learner
        actor = [p.detach().clone() for p in learner.actor_params.parameters()]
        target = [p.clone() for p in learner.actor_target_params.parameters()]
        astate, _ = bound.learn(astate, gen)
        torch.cuda.synchronize()
        open_ = astate.learner.step % bound.policy_learner.actor_update_freq == 0
        same_actor = all(torch.equal(a, b) for a, b in zip(actor, astate.learner.actor_params.parameters()))
        same_target = all(torch.equal(a, b) for a, b in zip(
            target, astate.learner.actor_target_params.parameters()))
        assert same_actor == same_target == (not open_), (open_, same_actor, same_target)
        gates.append(open_)
    assert sorted(gates) == [False, True], gates
    print(f"td3 delay gate: the actor and its target held exactly on the closed learn and moved "
          f"on the open one (learn steps {astate.learner.step - 1}, {astate.learner.step})",
          flush=True)
    return out


def run_continuous_learning(card):
    """Continuous SAC must reach Pendulum -250 (test_convergence.py:62-71,
    161-167: 16 envs, one learn per step after 1000, 2 rounds of 100, seed
    42, within 300000 env steps)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import Pendulum
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(
        policy_learner=continuous_learner(
            "csac", training_rounds=2, batch_size=100, entropy_coef=0.1,
            actor_learning_rate=1e-3, critic_learning_rate=1e-3,
        ),
        replay_buffer=BasicReplayBuffer(capacity=100_000),
    )
    t0 = time.perf_counter()
    res = online_learning(
        agent, Pendulum(), num_envs=16, max_steps=300_000, learn_every_k_steps=1,
        learning_starts=1_000, seed=42, target_return=-250.0, target_window=20,
    )
    seconds = time.perf_counter() - t0
    last = float(np.mean(res.episode_returns[-20:])) if len(res.episode_returns) else float("nan")
    print(f"continuous learning: reached_target={res.reached_target} after {res.total_steps} env "
          f"steps in {seconds:.1f} s, {len(res.episode_returns)} episodes, last-20 mean return "
          f"{last:.1f} on {card}", flush=True)
    assert res.reached_target, "online_learning did not reach Pendulum -250 with continuous SAC"
    return res.total_steps, seconds


def kernels_per_step_and_learn(agent, env, astate, env_states, gen, num_envs, after_learn=None):
    """The device kernels of one env step and of one learn, counted apart:
    each the difference of two profiled windows of different lengths (8 and
    72 steps, 4 and 20 learns), so that what a window's edges add or lose
    cancels. `after_learn(astate)` checks each learn's result. Returns
    (per step, per learn, step counts, learn counts, the state after)."""
    from pearl_tpu_torch.envs import VectorEnv

    bound = agent.for_env(env)
    venv = VectorEnv(env, num_envs, torch.device("cuda"))
    box = {"astate": astate, "env_states": env_states}

    def env_steps(n):
        a, e = box["astate"], box["env_states"]
        for _ in range(n):
            a, choice = bound.act(a, gen)
            e, result, next_obs = venv.step(e, choice.action, gen)
            a = bound.observe(a, result, next_obs, gen)
        box.update(astate=a, env_states=e)

    def learns(n):
        a = box["astate"]
        for _ in range(n):
            a, _ = bound.learn(a, gen)
            if after_learn is not None:
                after_learn(a)
        box["astate"] = a

    def per_unit(fn, short, long):
        counts = [device_kernels(lambda: fn(n)) for n in (short, long)]
        return (counts[1] - counts[0]) / (long - short), counts

    per_step, step_counts = per_unit(env_steps, 8, 72)
    per_learn, learn_counts = per_unit(learns, 4, 20)
    return per_step, per_learn, step_counts, learn_counts, box["astate"], box["env_states"]


# On-policy: the PPO workload of bench.py:316-341, nothing cut.
PPO_B, PPO_SPL, PPO_LPC = 131_072, 8, 16


def run_ppo_runner(card):
    """`make_compiled_runner` at bench.py's PPO width: a warm-up call and four
    timed calls, each synchronised and timed on its own, through an agent
    that checks on the host (cursor and size are host integers) that every
    learn finds one whole rollout and leaves the buffer empty; the actions
    of each call's last rollout are indices in {0, 1}. Then a profiled call,
    the device kernels of one env step and of one learn, and the losses of
    one more learn."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ProximalPolicyOptimization,
    )
    from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    capacity = PPO_SPL * PPO_B

    @dataclasses.dataclass(frozen=True, eq=False)
    class CheckedAgent(PearlAgent):
        learns: list = dataclasses.field(default_factory=lambda: [0])

        def learn(self, astate, generator, indices=None):
            replay = astate.replay
            assert (replay.size, replay.cursor) == (capacity, 0), (replay.size, replay.cursor)
            astate, metrics = super().learn(astate, generator, indices)
            assert (astate.replay.size, astate.replay.cursor) == (0, 0)
            self.learns[0] += 1
            return astate, metrics

    agent = CheckedAgent(
        policy_learner=ProximalPolicyOptimization(training_rounds=1, batch_size=1024),
        replay_buffer=OnPolicyReplayBuffer(capacity=capacity, num_envs=PPO_B),
    )
    env = CartPole()
    init_fn, run_fn = make_compiled_runner(
        agent, env, num_envs=PPO_B, steps_per_learn=PPO_SPL, learns_per_call=PPO_LPC
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cuda")
    steps_per_call = PPO_SPL * PPO_LPC
    fused_before = fused_mlp.launches

    def check_call(astate, stats):
        storage = astate.replay.storage
        index = storage.action_index
        assert ((index == 0) | (index == 1)).all() and torch.equal(storage.action[:, 0],
                                                                   index.float())
        assert stats["reward_sum"].item() == steps_per_call * PPO_B

    t0 = time.perf_counter()
    astate, env_states, stats = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    print(f"ppo runner warm-up call: {time.perf_counter() - t0:.3f} s", flush=True)
    check_call(astate, stats)
    rates = []
    for _ in range(4):
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates.append(steps_per_call * PPO_B / (time.perf_counter() - t0))
        check_call(astate, stats)
    assert agent.learns[0] == 5 * PPO_LPC and astate.learner.step == 5 * PPO_LPC
    assert fused_mlp.launches == fused_before  # this path reaches no kernel of the port
    episodes = stats["episodes"].item()
    assert episodes > 0, episodes
    print(f"ppo runner: env-steps/s per timed call {', '.join(f'{r:.1f}' for r in rates)} "
          f"(median {statistics.median(rates):.1f}); last call episodes={episodes}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
    wall_s = steps_per_call * PPO_B / statistics.median(rates)
    prof = profile_call(run_fn, astate, env_states, gen, wall_s)

    def emptied(a):
        assert (a.replay.size, a.replay.cursor) == (0, 0)

    # The windows' learns read a rollout the steps before them pushed; each
    # learn clears the buffer, so the plain agent counts them.
    plain = PearlAgent(policy_learner=agent.policy_learner, replay_buffer=agent.replay_buffer)
    per_step, per_learn, step_counts, learn_counts, astate, env_states = (
        kernels_per_step_and_learn(plain, env, astate, env_states, gen, PPO_B, emptied))
    astate = check_learn_metrics(agent, env, fill_rollout(plain, env, astate, env_states, gen,
                                                          PPO_B, PPO_SPL), gen, "ppo")
    per_call = steps_per_call * per_step + PPO_LPC * per_learn
    print(f"ppo runner: {per_step:.1f} device kernels per env step (windows of 8 and 72 steps: "
          f"{step_counts}), {per_learn:.1f} per learn (training_rounds=1, batch 1024 of "
          f"{capacity} rows; windows of 4 and 20: {learn_counts}), so {per_call:.0f} per call "
          f"besides the runner's own sums (the profiled call: {prof and prof['device_kernels']}) "
          f"on {card}", flush=True)
    return {"rates": rates, "profile": prof, "kernels_per_step": per_step,
            "kernels_per_learn": per_learn}


def fill_rollout(agent, env, astate, env_states, gen, num_envs, steps):
    """`steps` env steps through `agent`, no learn: a whole rollout for an
    on-policy buffer. Returns the agent state."""
    from pearl_tpu_torch.envs import VectorEnv

    bound = agent.for_env(env)
    venv = VectorEnv(env, num_envs, torch.device("cuda"))
    for _ in range(steps):
        astate, choice = bound.act(astate, gen)
        env_states, result, next_obs = venv.step(env_states, choice.action, gen)
        astate = bound.observe(astate, result, next_obs, gen)
    return astate


def run_ppo_learning(card):
    """PPO must reach CartPole 500 (test_convergence.py:135-146: 16 envs, a
    rollout of 16, 20 rounds of 64, clip 0.1, learning rates 1e-4, learning
    from the start, seed 42, within 400000 env steps)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ProximalPolicyOptimization,
    )
    from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer
    from pearl_tpu_torch.training import online_learning

    num_envs, rollout = 16, 16
    agent = PearlAgent(
        policy_learner=ProximalPolicyOptimization(
            training_rounds=20, batch_size=64, epsilon=0.1,
            actor_learning_rate=1e-4, critic_learning_rate=1e-4,
        ),
        replay_buffer=OnPolicyReplayBuffer(capacity=rollout * num_envs, num_envs=num_envs),
    )
    t0 = time.perf_counter()
    res = online_learning(
        agent, CartPole(), num_envs=num_envs, max_steps=400_000, learn_every_k_steps=rollout,
        learning_starts=0, seed=42, target_return=500.0, target_window=20,
    )
    seconds = time.perf_counter() - t0
    last = float(np.mean(res.episode_returns[-20:])) if len(res.episode_returns) else 0.0
    print(f"ppo learning: reached_target={res.reached_target} after {res.total_steps} env "
          f"steps in {seconds:.1f} s, {len(res.episode_returns)} episodes, last-20 mean return "
          f"{last:.1f} on {card}", flush=True)
    assert res.reached_target, "online_learning did not reach CartPole 500 with PPO"
    return res.total_steps, seconds


def run_discrete_actor_critic(card):
    """Discrete SAC at 1024 CartPole envs through `make_compiled_runner` (a
    warm-up and a timed call), then one act, env step, observe and learn
    under `torch.cuda.set_sync_debug_mode("error")`: the actor's learning
    rate, decayed at every observe, stays on the device. Then one learn each,
    on SyntheticAtari's 84x84x4 frames at 64 envs, of REINFORCE and PPO with
    the CNN actor and value network and of discrete SAC with the CNN actor
    and twin critic. Every loss must be finite."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole, SyntheticAtari, VectorEnv
    from pearl_tpu_torch.neural_networks import CNNActorNetwork, CNNTwinCritic, CNNValueNetwork
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        REINFORCE, ProximalPolicyOptimization, SoftActorCritic,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, OnPolicyReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    fused_before = fused_mlp.launches
    num_envs, spl, lpc = 1_024, 8, 16
    agent = PearlAgent(
        policy_learner=SoftActorCritic(training_rounds=1, batch_size=1024),
        replay_buffer=BasicReplayBuffer(capacity=16 * num_envs),
    )
    env = CartPole()
    init_fn, run_fn = make_compiled_runner(
        agent, env, num_envs=num_envs, steps_per_learn=spl, learns_per_call=lpc
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cuda")
    lr = astate.learner.actor_opt.param_groups[0]["lr"]
    assert lr.device.type == "cuda" and astate.learner.actor_opt.defaults["capturable"]
    rates = []
    for call in range(2):  # a warm-up and a timed call
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates.append(spl * lpc * num_envs / (time.perf_counter() - t0))
    index = astate.replay.storage.action_index
    assert ((index == 0) | (index == 1)).all()
    bound = agent.for_env(env)
    venv = VectorEnv(env, num_envs, torch.device("cuda"))
    lr_before = lr.item()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        astate, choice = bound.act(astate, gen)
        env_states, result, next_obs = venv.step(env_states, choice.action, gen)
        astate = bound.observe(astate, result, next_obs, gen)
        astate, metrics = bound.learn(astate, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    values = {k: v.item() for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()), values
    assert lr is astate.learner.actor_opt.param_groups[0]["lr"] and 0 < lr.item() <= lr_before
    print(f"discrete sac runner (1024 CartPole envs): env-steps/s warm-up {rates[0]:.1f}, "
          f"timed {rates[1]:.1f}; one act, env step, observe and learn made no host sync; "
          f"actor learning rate {lr.item():.6e} after {astate.learner.step} learns; "
          + ", ".join(f"{k}={v:.6f}" for k, v in values.items()) + f" on {card}", flush=True)

    n, steps = 64, 8
    atari = SyntheticAtari()
    learners = {
        "reinforce (CNN actor and value)": (REINFORCE(
            actor_network=CNNActorNetwork(), critic_network=CNNValueNetwork()), True),
        "ppo (CNN actor and value)": (ProximalPolicyOptimization(
            actor_network=CNNActorNetwork(), critic_network=CNNValueNetwork(),
            training_rounds=2, batch_size=64), True),
        "discrete sac (CNN actor and twin critic)": (SoftActorCritic(
            actor_network=CNNActorNetwork(), critic_network=CNNTwinCritic(),
            training_rounds=1, batch_size=64), False),
    }
    for name, (learner, on_policy) in learners.items():
        buffer = (OnPolicyReplayBuffer(capacity=steps * n, num_envs=n) if on_policy
                  else BasicReplayBuffer(capacity=steps * n))
        cnn_agent = PearlAgent(policy_learner=learner, replay_buffer=buffer)
        init_fn, run_fn = make_compiled_runner(
            cnn_agent, atari, num_envs=n, steps_per_learn=steps, learns_per_call=1, learn=False
        )
        a, e = init_fn(0)
        a, e, _ = run_fn(a, e, gen)  # one rollout of 8 steps, no learn
        assert a.replay.size == steps * n
        a, metrics = cnn_agent.for_env(atari).learn(a, gen)
        values = {k: v.item() for k, v in metrics.items()}
        assert values and all(math.isfinite(v) for v in values.values()), (name, values)
        assert a.replay.size == (0 if on_policy else steps * n)
        print(f"{name} on SyntheticAtari 84x84x4 at {n} envs, one learn: "
              + ", ".join(f"{k}={v:.6f}" for k, v in values.items()), flush=True)
    assert fused_mlp.launches == fused_before  # these paths reach no kernel of the port
    return rates


# The driver workloads of bench.py:343-466: bench.py:176-211's headline agent
# at its width through `online_learning`, nothing cut.
DRV_B, DRV_SPL, DRV_CPD, DRV_CAPACITY = 131_072, 8, 64, 2_097_152


def headline_agent():
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    return PearlAgent(
        policy_learner=DeepQLearning(
            q_network=MultiHeadQValueNetwork(), training_rounds=1, batch_size=1024
        ),
        replay_buffer=BasicReplayBuffer(capacity=DRV_CAPACITY),
    )


def reset_fused_counts():
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp

    fused_mlp.launches = 0
    fused_mlp.launches_by_body = dict.fromkeys(fused_mlp.launches_by_body, 0)


def fused_counts():
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp

    return {"launches": fused_mlp.launches, "by_body": dict(fused_mlp.launches_by_body)}


def driver_body_counts(dispatches, cpd=DRV_CPD):
    """B1's launches in `dispatches` dispatches of the headline driver: one
    act a step (B = 131072, the tiled body), the online and the target Q of
    each learn (B = 1024, the rows body)."""
    return {"tiled": DRV_SPL * cpd * dispatches, "rows": 2 * cpd * dispatches, "general": 0}


def timed_driver(agent, dispatches, seed, cpd=DRV_CPD, **kw):
    """`online_learning` for `dispatches` dispatches at the headline width with
    an unreachable target (early stopping live, as in bench.py), timed with
    the host clock to a synchronise: set-up, the dispatches and every host
    fetch, as a user's call."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    t0 = time.perf_counter()
    res = online_learning(
        agent, CartPole(), num_envs=DRV_B, max_steps=DRV_B * DRV_SPL * cpd * dispatches,
        learn_every_k_steps=DRV_SPL, chunks_per_dispatch=cpd, seed=seed, target_return=1e9,
        target_window=20, **kw,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert res.total_steps == DRV_B * DRV_SPL * cpd * dispatches and not res.reached_target
    return res, wall


def driver_dispatcher(agent, astate, env_states, stats, deferred_push=False, seed=0):
    """One more dispatch of the headline driver, continuing from `astate`:
    the driver's own chunk program and device accounting, without the host
    fetch that `online_learning` makes after it. Returns dispatch() -> the
    dispatch's statistics tensor, left on the card."""
    from pearl_tpu_torch.envs import CartPole, VectorEnv
    from pearl_tpu_torch.training import online as online_mod
    from pearl_tpu_torch.utils import make_generator

    dev = torch.device("cuda")
    env = CartPole()
    bound = agent.for_env(env)
    accounting = (online_mod._CurveStats(DRV_B, dev, DRV_B) if stats == "curves"
                  else {"summary": online_mod._SummaryStats,
                        "full": online_mod._FullStats}[stats](DRV_B, dev))
    chunk = online_mod._make_chunk_fn(bound, VectorEnv(env, DRV_B, dev), DRV_SPL, True, False,
                                      DRV_CPD, accounting, deferred_push)
    gen = make_generator(seed, dev)
    box = {"carry": (astate, env_states, torch.zeros(DRV_B, device=dev),
                     tuple(torch.zeros(DRV_B, device=dev) for _ in range(3)))}

    def dispatch():
        *carry, stats_dev = chunk(*box["carry"], gen)
        box["carry"] = tuple(carry)
        return stats_dev

    return dispatch


def no_sync(fn):
    """`fn()` under `torch.cuda.set_sync_debug_mode("error")`: any host sync
    inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_driver(card):
    """bench.py:409-466: `online_learning(stats="summary")` with the headline
    agent at 131072 envs, 8 steps per learn, 64 chunks per dispatch: a
    warm-up run of 2 dispatches and a timed run of 5, B1's launches by body
    counted over the timed run; then one more dispatch timed alone, one
    under the sync check and one profiled (the idle share)."""
    agent = headline_agent()
    res, wall = timed_driver(agent, 2, seed=0, stats="summary")
    print(f"driver warm-up (2 dispatches, set-up included): {wall:.3f} s", flush=True)
    reset_fused_counts()
    res, wall = timed_driver(agent, 5, seed=1, stats="summary")
    counts = fused_counts()
    assert counts["by_body"] == driver_body_counts(5), counts
    assert res.total_episodes > 0 and len(res.return_curve) == 5 * DRV_CPD
    assert np.isfinite(res.return_curve).all() and res.mean_return >= 1.0, res.mean_return
    assert res.episode_returns.shape == (0,)
    sps = res.total_steps / wall
    print(f"driver (stats='summary'): {sps:.1f} env-steps/s over 5 dispatches ({wall:.3f} s, "
          f"set-up included), {res.total_episodes} episodes, mean return "
          f"{res.mean_return:.3f}, last recent-return {res.return_curve[-1]:.3f}; B1 "
          f"{counts['launches']} launches, by body {counts['by_body']} on {card}", flush=True)
    dispatch = driver_dispatcher(agent, res.agent_state, res.env_states, "summary")
    t0 = time.perf_counter()
    rows = dispatch()
    torch.cuda.synchronize()
    dispatch_s = time.perf_counter() - t0
    rows = no_sync(dispatch)
    assert rows.shape == (DRV_CPD, 6) and torch.isfinite(rows).all()
    prof = profile_fn(dispatch, dispatch_s, unit="summary dispatch")
    print(f"driver: one dispatch {dispatch_s:.3f} s alone ({DRV_B * DRV_SPL * DRV_CPD / dispatch_s:.1f}"
          f" env-steps/s); one dispatch made no host sync on {card}", flush=True)
    return {"sps": sps, "counts": counts, "profile": prof, "dispatch_s": dispatch_s}


def run_curves(card):
    """bench.py:343-407: the same agent and width with stats="curves": the
    sampled stream (curve_capacity 131072, 64 chunks per dispatch; a warm-up
    run of 2 dispatches and a timed one of 5) and the lossless configuration
    (1 chunk per dispatch: a warm-up run of 4 and a timed one of 20, which
    must drop no episode); one sampled dispatch under the sync check; and
    curves bit-equal to full on the card at 1024 envs over 3 dispatches."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    out = {}
    agent = headline_agent()
    for name, cpd, warm, timed in (("sampled", DRV_CPD, 2, 5), ("lossless", 1, 4, 20)):
        res, wall = timed_driver(agent, warm, seed=0, cpd=cpd, stats="curves",
                                 curve_capacity=DRV_B)
        reset_fused_counts()
        res, wall = timed_driver(agent, timed, seed=1, cpd=cpd, stats="curves",
                                 curve_capacity=DRV_B)
        counts = fused_counts()
        assert counts["by_body"] == driver_body_counts(timed, cpd), counts
        drained = len(res.episode_returns)
        assert res.total_episodes == drained + res.episodes_dropped and drained > 0
        returns = res.episode_returns
        assert (returns >= 1).all() and (returns <= 500).all() and (returns == np.round(returns)).all()
        if name == "lossless":
            assert res.episodes_dropped == 0, res.episodes_dropped
        sps = res.total_steps / wall
        print(f"curves driver, {name} ({cpd} chunks per dispatch, R={DRV_B}): {sps:.1f} "
              f"env-steps/s over {timed} dispatches ({wall:.3f} s, set-up included); "
              f"{res.total_episodes} episodes, {drained} drained, {res.episodes_dropped} "
              f"dropped; B1 {counts['launches']} launches, by body {counts['by_body']} on {card}",
              flush=True)
        out[name] = {"sps": sps, "counts": counts, "episodes": res.total_episodes,
                     "drained": drained, "dropped": res.episodes_dropped}
        if name == "sampled":
            dispatch = driver_dispatcher(agent, res.agent_state, res.env_states, "curves")
            t0 = time.perf_counter()
            dispatch()
            torch.cuda.synchronize()
            dispatch_s = time.perf_counter() - t0
            snapshot = no_sync(dispatch)
            assert snapshot.shape == (3 * DRV_B + 2,)
            out["profile"] = profile_fn(dispatch, dispatch_s, unit="curves dispatch")
            print(f"curves driver: one dispatch {dispatch_s:.3f} s alone "
                  f"({DRV_B * DRV_SPL * DRV_CPD / dispatch_s:.1f} env-steps/s); one dispatch "
                  f"made no host sync on {card}", flush=True)

    # Curves equal full bit for bit at the same seed, on the card.
    runs = {}
    for stats in ("full", "curves"):
        runs[stats] = online_learning(
            headline_agent(), CartPole(), num_envs=1024, max_steps=1024 * 8 * 4 * 3,
            learn_every_k_steps=8, chunks_per_dispatch=4, seed=5, stats=stats,
            curve_capacity=4096,
        )
    full, curv = runs["full"], runs["curves"]
    assert curv.episodes_dropped == 0 and len(full.episode_returns) > 0
    for field in ("episode_returns", "episode_costs", "episode_risky_ratios"):
        assert np.array_equal(getattr(full, field), getattr(curv, field)), field
    for a, b in zip(full.agent_state.learner.params.parameters(),
                    curv.agent_state.learner.params.parameters()):
        assert torch.equal(a, b)
    print(f"curves equal full bit for bit at 1024 envs over 3 dispatches: "
          f"{len(full.episode_returns)} episodes, learner params equal on {card}", flush=True)
    out["equal_episodes"] = len(full.episode_returns)
    return out


def run_deferred_runner(card):
    """`make_compiled_runner(deferred_push=True)` at the headline width (64
    learns per call) beside the per-step runner in the same phase: a warm-up
    call each, then timed calls in the order per-step, deferred, deferred,
    per-step; the two keep the same replay cursor and size and the same B1
    launches by body. Then one deferred dispatch of the driver under the
    sync check."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    runners = {}
    for deferred in (False, True):
        init_fn, run_fn = make_compiled_runner(
            headline_agent(), CartPole(), num_envs=DRV_B, steps_per_learn=DRV_SPL,
            learns_per_call=DRV_CPD, deferred_push=deferred,
        )
        astate, env_states = init_fn(0)
        gen = make_generator(0, "cuda")
        astate, env_states, _ = run_fn(astate, env_states, gen)  # warm-up
        runners[deferred] = [run_fn, astate, env_states, gen]
    torch.cuda.synchronize()
    rates = {False: [], True: []}
    counts = {}
    for deferred in (False, True, True, False):
        run_fn, astate, env_states, gen = runners[deferred]
        reset_fused_counts()
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates[deferred].append(DRV_B * DRV_SPL * DRV_CPD / (time.perf_counter() - t0))
        counts[deferred] = fused_counts()
        assert counts[deferred]["by_body"] == driver_body_counts(1), counts
        assert stats["reward_sum"].item() == DRV_B * DRV_SPL * DRV_CPD
        runners[deferred][1:3] = [astate, env_states]
    a, b = runners[False][1].replay, runners[True][1].replay
    assert (a.cursor, a.size) == (b.cursor, b.size), ((a.cursor, a.size), (b.cursor, b.size))
    index = b.storage.action_index
    assert ((index == 0) | (index == 1)).all()
    print(f"deferred runner ({DRV_B} envs, {DRV_CPD} learns per call), env-steps/s in the order "
          f"run: "
          f"per-step {rates[False][0]:.1f}, deferred {rates[True][0]:.1f}, deferred "
          f"{rates[True][1]:.1f}, per-step {rates[False][1]:.1f}; B1 by body per call "
          f"{counts[True]['by_body']} on {card}", flush=True)
    agent = headline_agent()
    _, astate, env_states, _ = runners[True]
    dispatch = driver_dispatcher(agent, astate, env_states, "full", deferred_push=True)
    stats_dev = no_sync(dispatch)
    assert stats_dev.shape == (4, DRV_SPL * DRV_CPD, DRV_B)
    print(f"deferred driver: one dispatch made no host sync on {card}", flush=True)
    return {"rates": rates, "counts": counts[True]}


def run_dqn_family(card):
    """The rest of the DQN family's first half at 1024 CartPole envs through
    `make_compiled_runner` (batch 1024, 8 steps per learn, 16 learns per
    call): Dueling DQN, QR-DQN risk-neutral and mean-variance, deep SARSA
    with its buffer, and the multi-head DQN with Warmup(Boltzmann) and with
    each tie-breaking strategy. A warm-up and a timed call each; every stored
    action index in {0, 1}; the losses of one more learn finite."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import DuelingQValueNetwork, MultiHeadQValueNetwork
    from pearl_tpu_torch.policy_learners.exploration_modules import (
        BoltzmannExploration, TiebreakingStrategy, Warmup,
    )
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        DeepQLearning, DeepSARSA, QuantileRegressionDeepQLearning,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, SARSAReplayBuffer
    from pearl_tpu_torch.safety_modules import QuantileNetworkMeanVarianceSafetyModule
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    n, spl, lpc = 1_024, 8, 16
    kw = dict(training_rounds=1, batch_size=1024)
    multihead = MultiHeadQValueNetwork()
    agents = {
        "dueling dqn": PearlAgent(policy_learner=DeepQLearning(
            q_network=DuelingQValueNetwork(), **kw)),
        "qr-dqn risk-neutral": PearlAgent(policy_learner=QuantileRegressionDeepQLearning(**kw)),
        "qr-dqn mean-variance": PearlAgent(
            policy_learner=QuantileRegressionDeepQLearning(**kw),
            safety_module=QuantileNetworkMeanVarianceSafetyModule()),
        "deep sarsa": PearlAgent(policy_learner=DeepSARSA(**kw),
                                 replay_buffer=SARSAReplayBuffer(capacity=spl * n, num_envs=n)),
        "dqn warmup(boltzmann)": PearlAgent(policy_learner=DeepQLearning(
            q_network=multihead, exploration=Warmup(base=BoltzmannExploration(), warmup_steps=
                                                    spl * lpc * n), **kw)),
    }
    for strategy in TiebreakingStrategy:
        agents[f"dqn {strategy.name.lower()}"] = PearlAgent(policy_learner=DeepQLearning(
            q_network=multihead, tiebreaking=strategy, **kw))
    env = CartPole()
    out = {}
    for name, agent in agents.items():
        if not isinstance(agent.replay_buffer, SARSAReplayBuffer):
            agent = dataclasses.replace(agent, replay_buffer=BasicReplayBuffer(
                capacity=spl * lpc * n))
        init_fn, run_fn = make_compiled_runner(agent, env, num_envs=n, steps_per_learn=spl,
                                               learns_per_call=lpc)
        astate, env_states = init_fn(0)
        gen = make_generator(0, "cuda")
        rates = []
        for _ in range(2):  # a warm-up and a timed call
            t0 = time.perf_counter()
            astate, env_states, stats = run_fn(astate, env_states, gen)
            torch.cuda.synchronize()
            rates.append(spl * lpc * n / (time.perf_counter() - t0))
        storage = astate.replay.storage
        for field in ("action_index", "next_action_index"):
            index = getattr(storage, field)
            assert index is None or ((index == 0) | (index == 1)).all(), (name, field)
        assert stats["reward_sum"].item() == spl * lpc * n
        astate = check_learn_metrics(agent, env, astate, gen, name)
        out[name] = rates
        print(f"{name} runner ({n} CartPole envs): env-steps/s warm-up {rates[0]:.1f}, timed "
              f"{rates[1]:.1f} on {card}", flush=True)
    return out


def print_kernel_resources(build_dir):
    """Registers and spills of the redesigned kernels, as ptxas reported them
    at this build (the build keeps its output beside each library)."""
    import re

    wanted = ("fused_mlp_tiled_kernel", "fused_mlp_rows_kernel", "fused_mlp_general_kernel",
              "ring_conv1_mma_kernel")
    for report in sorted(build_dir.glob("*.ptxas.txt")):
        blocks = re.split(r"ptxas info\s*: Compiling entry function '", report.read_text())
        for block in blocks[1:]:
            symbol = block.split("'", 1)[0]
            used = re.search(r"Used (\d+) registers", block)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            if used and any(w in symbol for w in wanted):
                print(f"ptxas: {symbol}: {used.group(1)} registers, spill stores/loads "
                      f"{spills.group(1)}/{spills.group(2)} bytes", flush=True)


REPLACES = {
    "ring_write": "pearl_tpu/ops/ring_write.py:119",
    "ring_write_where": "pearl_tpu/ops/ring_write.py:84",
    "copy_fence": "pearl_tpu/ops/layout_fence.py:138",
    "masked_scale_fence": "pearl_tpu/ops/layout_fence.py:182",
    "masked_scale_fence4": "pearl_tpu/ops/layout_fence.py:104",
    "cache_write": "pearl_tpu/ops/conv_cache.py:106",
    "ring_conv1": "pearl_tpu/ops/ring_conv.py:208",
}
SOURCES = {
    "ring_write": "pearl_tpu_torch/csrc/ring_write.cu",
    "ring_write_where": "pearl_tpu_torch/csrc/ring_write.cu",
    "copy_fence": "pearl_tpu_torch/csrc/layout_fence.cu",
    "masked_scale_fence": "pearl_tpu_torch/csrc/layout_fence.cu",
    "masked_scale_fence4": "pearl_tpu_torch/csrc/layout_fence.cu",
    "cache_write": "pearl_tpu_torch/csrc/conv_cache.cu",
    "ring_conv1": "pearl_tpu_torch/csrc/ring_conv.cu",
}


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    from pearl_tpu_torch.ops import _build

    sources = ["fused_mlp", "ring_write", "layout_fence", "conv_cache", "ring_conv"]
    for name, path in _build.build_all(sources).items():
        print(f"built {name}: {path}", flush=True)
    print_kernel_resources(_build.BUILD_DIR)
    phase("build", t0)

    t0 = time.perf_counter()
    max_err, timing = check_fused_mlp(card)
    visual_timing = check_visual_kernels(card)
    visual_timing.update(check_act_kernels(card))
    phase("kernels", t0)

    t0 = time.perf_counter()
    launches, fused_by_body = run_runner(card)
    phase("runner", t0)

    t0 = time.perf_counter()
    run_learning(card)
    phase("learning", t0)

    t0 = time.perf_counter()
    visual_launches, sps_default = run_visual_runner(card, frames=1, calls=2)
    multichannel, _ = run_visual_runner(card, frames=VIS_C, calls=2)
    assert multichannel["masked_scale_fence4"] == 0 == visual_launches["masked_scale_fence"]
    visual_launches["masked_scale_fence"] = multichannel["masked_scale_fence"]
    phase("visual runner", t0)

    t0 = time.perf_counter()
    cached, sps_cached = run_visual_runner(card, frames=1, calls=2, conv1_cache=True)
    fused, sps_fused = run_visual_runner(card, frames=1, calls=2, ring_conv=True)
    # The default path once more, so that the opt-in paths stand between two
    # runs of what they are compared with (the loop is host-bound and the
    # host's speed drifts within a run).
    _, sps_default_again = run_visual_runner(card, frames=1, calls=2)
    assert visual_launches["cache_write"] == 0 == visual_launches["ring_conv1"]
    assert cached["ring_conv1"] == 0 == fused["cache_write"]
    visual_launches["cache_write"] = cached["cache_write"]
    visual_launches["ring_conv1"] = fused_mma_launches = fused["ring_conv1"]
    print(
        f"1-channel visual runner, env-steps/s side by side, in the order run: default "
        f"{sps_default:.1f}, conv1_cache {sps_cached:.1f}, ring_conv {sps_fused:.1f}, default "
        f"again {sps_default_again:.1f} on {card}", flush=True)
    phase("visual runner, opt-in act paths", t0)

    t0 = time.perf_counter()
    run_csac_runner(card)
    phase("csac runner", t0)

    t0 = time.perf_counter()
    run_ddpg_td3_runners(card)
    phase("ddpg and td3 runners", t0)

    t0 = time.perf_counter()
    run_continuous_learning(card)
    phase("continuous learning", t0)

    t0 = time.perf_counter()
    run_ppo_runner(card)
    phase("ppo runner", t0)

    t0 = time.perf_counter()
    run_ppo_learning(card)
    phase("ppo learning", t0)

    t0 = time.perf_counter()
    run_discrete_actor_critic(card)
    phase("discrete actor-critic", t0)

    t0 = time.perf_counter()
    driver = run_driver(card)
    phase("driver", t0)

    t0 = time.perf_counter()
    curves = run_curves(card)
    phase("curves", t0)

    t0 = time.perf_counter()
    deferred = run_deferred_runner(card)
    phase("deferred runner", t0)

    t0 = time.perf_counter()
    reset_fused_counts()
    run_dqn_family(card)
    family = fused_counts()
    assert family["by_body"]["tiled"] == 0 < family["by_body"]["rows"], family
    phase("dqn family", t0)

    act = timing[ACT_SHAPE[0]]
    kernels = [{
        "name": "fused_mlp",
        "route": "cuda",
        "source": "pearl_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "pearl_tpu/ops/fused_mlp.py:77",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": act["ms"],
        "plain_ms": act["plain_ms"],
        "bound_ms": act["bound_ms"],
        "bound_by": act["bound_by"],
        "library_ms": None,
        "body": act["body"],
        "launches_by_body": fused_by_body,
        # Each later path's B1 launches, counted from 0 over its own run.
        "launches_by_path": {
            "driver (summary, 5 dispatches)": driver["counts"],
            "curves, sampled (5 dispatches)": curves["sampled"]["counts"],
            "curves, lossless (20 dispatches)": curves["lossless"]["counts"],
            "deferred runner (one call)": deferred["counts"],
            "dqn family (1024 envs)": family,
        },
        "fma_probe_tflops": [act["fma_probe_128_tflops"], act["fma_probe_1024_tflops"]],
        "learn_shape": timing[LEARN_SHAPE[0]],
    }]
    for name, t in visual_timing.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": visual_launches[name],
            **t,
        })
    assert kernels[-1]["name"] == "ring_conv1"
    kernels[-1]["mma_launches"] = fused_mma_launches
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} was not launched on its path"
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
