"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: needs CUDA (exits non-zero without it); prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles every kernel of the port from `pearl_tpu_torch/csrc`
     (one nvcc per source, all at once);
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes the main path gives it, forward and gradients, and times
     kernel and plain version with CUDA events;
  4. runner: drives `make_compiled_runner` at the full width of the DQN
     CartPole workload (131072 envs) and checks that every Q evaluation went
     through the kernel;
  5. learning: `online_learning` must reach CartPole return 500.
Then one JSON line per kernel set, the card line, and the final JSON line.
Any failure raises before the last line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

ACT_SHAPE = (131_072, (4, 64, 64, 2))
LEARN_SHAPE = (1_024, (4, 64, 64, 2))
CHECK_SHAPES = [ACT_SHAPE, LEARN_SHAPE, (1_031, (5, 32, 48, 16, 3)), (37, (4, 64, 64, 2))]


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, launches=25, sleep_cycles=40_000_000):
    """Median device time of one call of `fn`, in ms. A long sleep kernel is
    queued first so that every timed call is enqueued before the card
    reaches it: the events then time the card, not the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(launches)]
    torch.cuda._sleep(sleep_cycles)
    for start, end in events:
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
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    timing = {}
    for B, dims in CHECK_SHAPES:
        x, wb = mlp_operands(B, dims, gen)
        y = fused_mlp(x, *wb)
        torch.cuda.synchronize()
        ref = fused_mlp_reference(x, wb)
        # f32 both ways; the sums run in another order: rtol/atol 1e-5.
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
        err = (y - ref).abs().max().item()
        max_err = max(max_err, err)

        leaves = [t.clone().requires_grad_() for t in (x, *wb)]
        (fused_mlp(*leaves) ** 2).sum().backward()
        ref_leaves = [t.clone().requires_grad_() for t in (x, *wb)]
        (fused_mlp_reference(ref_leaves[0], ref_leaves[1:]) ** 2).sum().backward()
        torch.cuda.synchronize()
        for a, b in zip(leaves, ref_leaves):
            # Gradients of sum(y^2) scale with the forward difference: 1e-4.
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)
        print(f"fused_mlp B={B} dims={dims}: max_abs_err={err:.3e} forward+grads ok", flush=True)

        if (B, dims) in (ACT_SHAPE, LEARN_SHAPE):
            ms = device_ms(lambda: fused_mlp(x, *wb))
            plain_ms = device_ms(lambda: fused_mlp_reference(x, wb))
            bound_ms, bound_by = mlp_bound_ms(B, dims)
            timing[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(
                f"fused_mlp B={B} dims={dims}: kernel {ms:.4f} ms, plain version "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {card}",
                flush=True,
            )
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
        f"{launches} fused_mlp launches ({per_call} per call), last call "
        f"reward_sum={reward_sum:.0f} episodes={episodes}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    profile_call(run_fn, astate, env_states, gen, elapsed / calls)
    return launches


def profile_call(run_fn, astate, env_states, gen, wall_s):
    """Device time of one more runner call, by kernel, from torch.profiler;
    set against the unprofiled wall time of a call it gives the card's idle
    share. Outside the launch count: the count is read before this call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_fn(astate, env_states, gen)
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
        return
    print(
        f"profile: device busy {busy_s * 1e3:.3f} ms per runner call in {n_device} "
        f"kernels and copies, unprofiled wall {wall_s * 1e3:.3f} ms per call, "
        f"idle share {1 - busy_s / wall_s:.4f}",
        flush=True,
    )
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile:   {us / 1e3:10.3f} ms  {100 * us / 1e6 / busy_s:5.1f}%  {name[:90]}")


def run_learning(card):
    import numpy as np

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

    for name, path in _build.build_all(["fused_mlp"]).items():
        print(f"built {name}: {path}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    max_err, timing = check_fused_mlp(card)
    phase("kernels", t0)

    t0 = time.perf_counter()
    launches = run_runner(card)
    phase("runner", t0)

    t0 = time.perf_counter()
    run_learning(card)
    phase("learning", t0)

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
        "learn_shape": timing[LEARN_SHAPE[0]],
    }]
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
