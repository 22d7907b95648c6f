"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its seconds:
  1. device: needs CUDA (exits non-zero without it); prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles every kernel of the port from `pearl_tpu_torch/csrc`
     (one nvcc per source, all at once);
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the shapes the main paths give it (and at ragged ones; B1 also at
     the classic runners' widths), every body of
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
     and replay) with the act's fences asked for (`ring_conv=False`) and
     checks the exact launch counts of the ring and fence kernels, the ring
     and replay bookkeeping and the Q values; then the same composition, at
     the same width, on the env's default 4-channel frames (a 231 MB ring),
     the path of `masked_scale_fence`; then the two other act paths of the
     1-channel composition, each at full width: the conv1 cache
     (`conv1_cache=True`, the path of `cache_write`) and the ring conv
     (`ring_conv=True`, the path of `ring_conv1` and the network's default
     on this ring, every launch in the tensor-core body);
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
 11. ppo learning: `online_learning` with PPO must reach CartPole 500, in
     a child process started after phase 8 (which then runs phase 39's
     learning check) and waited for after phases 5, 9, 28 and 20, which run
     then, in that order (host-bound learning anchors that report no rate,
     side by side with it and with phase 44's ranks; phase 10 and every
     later rate wait for the children);
 12. discrete actor-critic: discrete SAC at 1024 CartPole envs through the
     runner, with one act, env step, observe and learn that must make no
     host sync; then one learn each of REINFORCE and PPO with the CNN actor
     and value network and of discrete SAC with the CNN twin critic, on
     SyntheticAtari frames at 64 envs.
 13. driver: `online_learning(stats="summary")` with the headline agent at
     its width (bench.py:409-466: 131072 envs, 8 steps per learn, 64 chunks
     per dispatch): a warm-up run of 1 dispatch, a timed run of 2 with
     B1's launches by body (act tiled, learn rows), one dispatch timed
     alone, one under `set_sync_debug_mode("error")` (the host fetch
     excluded) and one profiled (the idle share);
 14. curves: the same with stats="curves" (bench.py:343-407): the sampled
     stream (curve_capacity 131072; a warm-up dispatch, 2 timed) with a
     dispatch under the sync check and
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
 17. packed runner: the headline runner with `PackedReplayBuffer` (bench.py's
     BENCH_BUFFER=packed) beside the per-field runner, timed calls in the
     order basic, packed, packed, basic; the kernels of one env step and of
     one learn and a profiled call of each; packed and per-field storage
     equal for the same indices at the runner's capacity;
 18. prioritized runner: the same with `PrioritizedReplayBuffer`: one call
     under the sync check, the write-back of one learn held to |td| +
     epsilon, the profiles, and the draws' chi-square over a fixed priority
     vector;
 19. bootstrapped dqn: the registry's two rows (K = 10 and K = 1) at 1024
     envs: the priors bit-identical after 64 learns, the masks' mean, z
     redrawn only where an episode ended;
 20. her learning: DQN with HER on the sparse reach task
     (test_convergence.py:193-219, its 150000 env steps cut to 20000), above
     0.95 success over the last 200 episodes;
 21. two-tower dqn and tabular q: one short runner call each;
 22. stacking visual runner: bench.py's BENCH_CNN_LEGACY=1 composition (the
     stacking summarizer over observations) beside the frame-ring runner,
     interleaved; on the ring runner's window the stacking path gives the
     ring path's Q values and greedy actions (the ring's oracle);
 23. lstm dqn: the registry's LSTMDQN row on positions-only CartPole at 1024
     envs, the summarizer moving in every learn, a call and a learn without
     a host sync; then the reference's LSTM learning anchor (mean return of
     the last tenth of the episodes above 100);
 24. transformer dqn: the same with the reference's transformer learner;
 25. lstm actor-critic: the registry's LSTMPPO and LSTMSAC rows at 1024 envs;
 26. rc: RCCSAC on Pendulum with its torque cost at 16 envs beside CSAC
     (lambda, episode cost and return after each of 2 calls), then RCPPO on
     CartPole with a risky half, the discrete path;
 27. masked headline runner: the headline runner on the dynamic action
     space with the availability masks in replay, beside the plain one,
     interleaved, B1 at 512 + 128 launches a call on both; its kernels and
     busy time against phase 17's plain runner (phase 18 likewise);
 28. offline iql anchor: the reference's offline IQL pipeline
     (test_convergence.py:222-263) from phase 9's CSAC agent: 50000
     transitions collected, IQL on 5000 batches of 256, a greedy evaluation
     over 40000 env steps whose mean return must be above -600; the device
     kernels of a learn_batch and a chunk of learning under the sync check;
 29. offline cql: 16384 greedy transitions from phase 5's multi-head DQN,
     conservative DQN with `MultiHeadQValueNetwork` on 1000 batches of 128,
     evaluated greedily: B1 launches in the learn and in the evaluation;
 30. discrete iql: the registry's DiscreteIQL row on CartPole at 1024 envs
     through the runner; the value net moves in every learn, a call and a
     learn make no host sync.
 31. classic runners: the headline agent at its width on Acrobot (B1 on
     6 -> 64 -> 64 -> 3: a warm-up call with every action in {0, 1, 2},
     a timed call, one act's Q values against `fused_mlp_reference`, a
     profiled call, the device kernels of a step and a learn) and on
     MountainCar (2 -> 64 -> 64 -> 3), B1 at 512 tiled + 128 rows launches
     a call on both; the registry's ContinuousSAC row on
     ContinuousMountainCar at 1024 envs, no kernel launch;
 32. frozen lake: DQN to the reference's anchor (return 1.0 five episodes
     in a row), tabular Q whose greedy table reaches the goal, and a runner
     call on the one-hot wrapper over the slippery lake, its slip drawn on
     the card;
 33. breakout: the registry's CNNDQN row at 1024 envs (a warm-up and a
     timed call, one act and one learn under the sync check) and the
     reference's tracking-paddle dynamics check;
 34. ple and puckworld: the registry's DQN row at 1024 envs, one call on
     each of Catcher, FlappyBird, Pixelcopter, Pong, PuckWorld and its PO,
     SR and SF variants (rewards in each game's set, no early horizon); then
     DQN on Catcher at the reference's settings at seed 42, its gate met
     (on the CPU: at 4 of 16 seeds in JAX, 3 of 16 in the port);
 35. recommender and bandit: DQN on the reference's recommender catalog (the
     mean of the last 50 returns above 10.5, beside the catalog's random and
     oracle click rates), QR-DQN risk-neutral and mean-variance on the
     mean-variance bandit (8000 env steps, the reference's 24000 cut; the
     risky and the safe arm on more than 90% of greedy acts).
 36. bandit anchors: the reference's bandit tests (tests/test_bandits.py)
     on the card: LinUCB on the synthetic env (greedy regret below 0.1), the
     disjoint UCB arms on the ten-times MAB (arm 3 everywhere), disjoint
     linear arms recovering W to 0.02, the neural-linear sigmoid head (loss
     below 0.01); an act, env step, observe and learn of LinUCB,
     NeuralLinUCB and the disjoint linear container without a host sync;
 37. cb benchmark: the reference's UCI CB protocol, the four CB methods on
     letter (T = 5000, 10 envs, seed 0), each below 0.75 beside JAX's CPU
     value, with interactions/s and the device kernels of an act and of a
     learn; the yeast NeuralSquareCB cell (below 0.5) and the offline
     protocol on satimage (below 0.4);
 38. linucb runner: the registry's LinUCB row through the runner at 131072
     envs, a learn every step: warm-up, timed calls, one under the sync
     check, a profiled call, the device kernels of a step and of a learn;
     the last call's mean regret below the first's.
 39. population: a member of `population_learning` equal to the solo
     `online_learning(stats="summary")` run at its seed (2 members of the
     reference test's DQN); the headline agent as 4 members at its width
     (131072 envs each, 64 chunks of 8 steps a dispatch): a warm-up
     dispatch under the sync check and profiled (the idle share against
     the timed dispatches' wall), then the solo summary driver, 2 timed
     population dispatches and the solo driver again, B1 at 512 tiled + 128
     rows a member and dispatch; the reference's 4-member learning check
     (16 envs, 40000 steps each) in phase 11's child after PPO's anchor,
     its population saved for phase 41;
 40. host loops: the multi-head DQN through `agent_online_learning_host`
     on CartPole, one env (steps/s, host syncs a step, B1 at B = 1 in every
     act), and the Atari agent of examples_torch/atari_dqn.py (its
     `make_agent()`) on SyntheticAtari at 84x84x4 with a 100000-row bf16
     replay;
 41. registry and checkpoint: every METHODS row trained briefly at 4 envs
     and round-tripped through `save`/`restore` with its CUDA generators,
     the population's states, and a conv1-cache agent whose restored cache
     equals a refresh; B1, B2, B3, B6b and B7 counted over the rows.
 42. dp world-1: `online_learning(mesh=make_mesh(1))` (NCCL, a world of one
     in this process; the path each rank takes with a card of its own) with
     the headline agent at its width, one dispatch, bit-equal to phase 13's
     solo warm-up run at the same seed (whole states, return curve), B1 at
     512 tiled + 128 rows; one more dispatch timed alone and one under the
     sync check (the fetch excluded) and profiled (the idle share); the
     mesh then closes the world it made;
 43. dp two ranks: two processes on cuda:0 joined by gloo (NCCL refuses two
     ranks on one card), 65536 envs each (131072 in all):
     `online_learning(mesh=..., check_replication=True)`, a warm-up dispatch
     and 2 timed ones with the replicas byte for byte equal after each, the
     folded statistics the same on both ranks, the env shards different, B1
     at 512 tiled + 128 rows a rank and dispatch; then `DataParallelRunner`
     and learns timed alone (host time a learn, gloo all-reduce included):
     a correctness run, its rates no scaling number;
 44. mesh anchor: test_convergence.py:289-316 (DQN to CartPole 500 on 16
     envs over 2 ranks, gloo on cuda:0), replicas equal at the end (spread
     0), in two child processes started beside phase 11's (rank processes
     load the kernels phase 2 built; none builds);
 45. ensemble: the registry's BootstrappedDQN (K = 10, batch 128) on a
     (1, 2) mesh of the same two ranks as phase 43, each holding 5 members:
     3 sharded learns equal the unsharded learn within rtol 1e-5 / atol 1e-6.
 46. examples: every script of examples_torch/ but atari_dqn (which needs
     gymnasium and the ROMs; phase 40 builds its agent) through its
     `main(device="cuda:0")` at a cut budget (`run_examples`): each prints
     its line and leaves its learner state on the card; multi_chip_dqn on
     an NCCL mesh of one, closed, then a second world of one; dp_scaling at
     width 1 on NCCL and at widths 1 and 2 on gloo (two ranks on cuda:0),
     its replicas byte for byte equal; no process group is left, so the run
     ends without PyTorch's `destroy_process_group()` warning.
 47. learning signal and fixed point: every METHODS row, and the example
     row of pearl_tpu_torch/EXTENDING.md, through the reference's
     frozen-target check on the card (4 envs; the loss above 1e-3 at the
     start, under 0.15 of it at the end, 0.30 for CNNDQN and CQL, a |TD|
     under 0.5), one line a row; DQN, Double DQN and deep SARSA at the
     Bellman fixed point 1 / (1 - gamma) = 10, and the gamma 0.45 control
     at 1.82; B1 counted over the MultiHeadDQN row, B2, B7, B3 and B6b over
     the VisualDQN row.
 Phases 7-12 reach no kernel of the port (their products are PyTorch's);
 13-15, 17-18, 27, 29, 31 and 39 reach B1 as the runner does, 16 and 40
 through their multi-head DQNs, 41 and 47 through the registry's MultiHeadDQN
 row (and B2, B7, B3, B6b through its VisualDQN row), 42 and 43 as the driver
 does (43 on each rank); 19-21, 23-26, 28, 30, 32-38, 44, 45 and 46 run plain
 PyTorch products
 (36-38: matrix products and small Cholesky solves),
 cuDNN's convolutions and LSTM (the reference's are flax stacks that XLA
 computes); 22's control runner reaches B7, B3 and B6b as phase 6 does.
Then one JSON line for the kernels, the card line, and the final JSON line.
Any failure raises before the last line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

ACT_SHAPE = (131_072, (4, 64, 64, 2))
LEARN_SHAPE = (1_024, (4, 64, 64, 2))
# The headline agent on Acrobot (act and learn) and on MountainCar (act).
CLASSIC_SHAPES = [(131_072, (6, 64, 64, 3)), (1_024, (6, 64, 64, 3)), (131_072, (2, 64, 64, 3))]
# The act of the host loop's multi-head DQN: one env.
HOST_ACT_SHAPE = (1, (4, 64, 64, 2))
WIDTH_SHAPES = CLASSIC_SHAPES + [HOST_ACT_SHAPE]
WIDE_DIMS = (7, 96, 130, 5)  # a layer wider than the tiled body takes
CHECK_SHAPES = [
    ACT_SHAPE, LEARN_SHAPE, (1_031, (5, 32, 48, 16, 3)), (37, (4, 64, 64, 2)),
    # A B that is no multiple of the tiled body's 128 rows, column tiles of
    # 8, 16 and 4 in one chain, and the wide chain in the rows and the
    # general body. `check_fused_mlp` adds the two B around the switch from
    # the rows body to the others, which depends on the card's SM count.
    (20_011, (4, 64, 64, 2)), (9_001, (5, 32, 48, 16, 3)), (300, WIDE_DIMS),
    (9_001, WIDE_DIMS),
] + WIDTH_SHAPES


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
    timing = {"widths": {}}
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

        if (B, dims) in [ACT_SHAPE, LEARN_SHAPE] + WIDTH_SHAPES:
            ms = device_ms(lambda: fused_mlp(x, *wb))
            plain_ms = device_ms(lambda: fused_mlp_reference(x, wb))
            bound_ms, bound_by = mlp_bound_ms(B, dims)
            t = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, body=body)
            if (B, dims) in WIDTH_SHAPES:
                # The act (B = 131072) in the tiled body, the learn and the
                # host loop's act (B = 1) in the rows body.
                assert body == ("tiled" if B == ACT_SHAPE[0] else "rows"), (B, dims, body)
                timing["widths"][f"B={B} dims={dims}"] = dict(t, max_abs_err=err)
            else:
                timing[B] = t
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


def device_events(fn):
    """(name, µs) of each kernel and copy the card ran for `fn()`, from
    torch.profiler's device activity. User annotations (Optimizer.step, ...)
    span kernels already counted and are left out. The raw Kineto events
    give the counts and busy time of `prof.events()` at a twentieth of its
    host time (0.5 s against 9.4-19.0 s for the 49866 events of one headline
    runner call on an H100), and device activity alone is traced as
    completely as with host activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(evt.name(), evt.duration_ns() / 1e3) for evt in prof.profiler.kineto_results.events()
            if evt.device_type() == DeviceType.CUDA and not evt.is_user_annotation()]


def profile_fn(fn, wall_s, unit="runner call", events=None):
    """Device time of one `fn()` by kernel, set against `wall_s`, the
    unprofiled wall time of one `fn()`: the card's idle share. `events`,
    from an earlier `device_events(fn)`, stand in for a new run of `fn`."""
    by_name = {}
    if events is None:
        events = device_events(fn)
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    n_device = len(events)
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
    return len(device_events(fn))


def run_learning(card):
    """The multi-head DQN must reach CartPole 500 (test_convergence.py:48-79).
    Returns the agent and its learner state: the offline cql phase's
    behaviour agent."""
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
    return agent, res.agent_state.learner


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
# conv1 as the benchmark's cells give it to B5 on the act path: 16384 envs, a
# window of 4 84x84 frames (a 925 MB bfloat16 ring), 8x8 stride 4, at the 2013
# DQN's 16 channels and Nature DQN's 32.
CONV_CELLS = [(16_384, 4, 84, 84, 8, 4, 16), (16_384, 4, 84, 84, 8, 4, 32)]


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
    # At the cells' shapes, in the mma body, the main path's only one there.
    for B, T, H, W, k, s, OC in CONV_CELLS:
        assert rc.pick_body(torch.bfloat16, T, H, W, k, s, OC) == "mma"
        ring, valid, wmat, bias = conv_operands(B, T, H, W, k, s, OC, torch.bfloat16)
        got = hold(ring, valid, wmat, bias, H, W, k, s, "mma")
        assert 0.2 < (got[1:] > 0).float().mean().item() < 0.8
        assert torch.equal(got[0].float().amax((1, 2)), torch.relu(bias).to(torch.bfloat16).float())
        rolled = torch.roll(wmat.view(T, k * k, OC), 1, 0).reshape(T * k * k, OC)
        hold(ring, torch.ones_like(valid), rolled, bias, H, W, k, s, "mma")
        del ring, valid, got
    print(f"ring_conv1 bfloat16: within rtol {tol[torch.bfloat16]['rtol']:.3e} atol "
          f"{tol[torch.bfloat16]['atol']:.0e} of the plain version in the mma body at the cells' "
          f"shapes {CONV_CELLS} (a rolled wmat with every frame valid at each), max abs err so "
          f"far {err['ring_conv1']:.3e}", flush=True)

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

    # At the cells' shapes, every frame valid (the main path after an
    # episode's first steps), beside what B5 replaced there.
    cells = timing["ring_conv1"]["cells"] = {}
    for B, T, H, W, k, s, OC in CONV_CELLS:
        ring, valid, wmat32, bias = conv_operands(B, T, H, W, k, s, OC, bf16)
        valid = torch.ones_like(valid)
        wmat = wmat32.to(bf16)
        OH, OW = (H - k) // s + 1, (W - k) // s + 1
        nbytes = (ring.numel() * 2 + valid.numel() + wmat.numel() * 2 + bias.numel() * 4
                  + B * OC * OH * OW * 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * B * T * OH * OW * OC * k * k / BF16_FLOP_PER_S
        w4 = (wmat32 * 255.0).to(bf16).reshape(T, k, k, OC).permute(3, 0, 1, 2).contiguous()
        b16 = bias.to(bf16)
        cell = cells[f"B={B} OC={OC}"] = dict(
            ms=ms(lambda: ring_conv1(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            fence4_conv2d_relu_ms=ms(lambda: F.relu(F.conv2d(
                masked_scale_fence4(ring, valid, H=H, W=W, div=255.0), w4, b16, stride=s))),
            body=rc.pick_body(bf16, T, H, W, k, s, OC),
        )
        del ring
        print(f"ring_conv1 B={B} T={T} {H}x{W} k={k} s={s} OC={OC} bfloat16 (body {cell['body']}), "
              f"every frame valid: kernel {cell['ms']:.4f} ms, bound {cell['bound_ms']:.4f} ms "
              f"({cell['bound_by']}), {100 * cell['bound_ms'] / cell['ms']:.1f}% of it; what it "
              f"replaces on the act path {cell['fence4_conv2d_relu_ms']:.4f} ms on {card}",
              flush=True)
    B, T, OC, OH, OW = bench4
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


ENV_FRAMES = (16_384, 84, 84, 1)  # the pixel cells' vector step: envs, H, W, frames


def check_env_kernel(card):
    """`synthetic_frames` against its plain version and against the env's
    path without it (two `SyntheticAtari._obs` grids and a `where`), bit for
    bit, at the pixel cells' step (bfloat16, one row in 128 done, as with
    episodes of 128) and at ragged float32 and bfloat16 shapes; times the
    kernel, its plain version and that path beside the bytes bound."""
    from pearl_tpu_torch.envs import SyntheticAtari, SyntheticAtariState
    from pearl_tpu_torch.ops.synthetic_frames import (
        synthetic_frames,
        synthetic_frames_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # over the 50 MB L2

    def operands(B, done_share):
        phase = torch.rand((B,), device="cuda", generator=gen) * 6.28
        t = torch.randint(0, 128, (B,), device="cuda", generator=gen, dtype=torch.int32)
        fresh = torch.rand((B,), device="cuda", generator=gen) * 6.28
        done = torch.rand((B,), device="cuda", generator=gen) < done_share
        return phase, t, fresh, done

    def env_path(env, phase, t, fresh, done):
        obs = env._obs(SyntheticAtariState(phase=phase, t=t + 1))
        reset = env._obs(SyntheticAtariState(phase=fresh, t=torch.zeros_like(t)))
        return obs, torch.where(done[:, None], reset, obs)

    for B, H, W, frames, dtype, share in [(37, 7, 5, 4, torch.float32, 0.5),
                                          (19, 5, 3, 3, torch.bfloat16, 0.5),
                                          (300, 84, 84, 4, torch.float32, 0.3),
                                          (*ENV_FRAMES, torch.bfloat16, 1 / 128)]:
        ops = operands(B, share)
        env = SyntheticAtari(height=H, width=W, frames=frames, obs_dtype=dtype)
        before = synthetic_frames.launches
        got = synthetic_frames(*ops, H=H, W=W, frames=frames, dtype=dtype)
        assert synthetic_frames.launches == before + 1
        plain = synthetic_frames_reference(*ops, H=H, W=W, frames=frames, dtype=dtype)
        today = env_path(env, *ops)
        torch.cuda.synchronize()
        for a, b, c in zip(got, plain, today):
            assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c)), (
                B, H, W, frames, dtype)
        print(f"synthetic_frames B={B} {H}x{W}x{frames} {dtype}: bit-equal to its plain "
              f"version and to two _obs grids + where ({int(ops[3].sum())} rows done)",
              flush=True)

    B, H, W, frames = ENV_FRAMES
    ops = operands(B, 1 / 128)
    env = SyntheticAtari(height=H, width=W, frames=frames, obs_dtype=torch.bfloat16)
    kw = dict(H=H, W=W, frames=frames, dtype=torch.bfloat16)
    nbytes = 2 * B * H * W * frames * 2 + B * 13

    def ms(fn):
        return device_ms(fn, flush=flush)

    timing = dict(
        ms=ms(lambda: synthetic_frames(*ops, **kw)),
        plain_ms=ms(lambda: synthetic_frames_reference(*ops, **kw)),
        obs_obs_where_ms=ms(lambda: env_path(env, *ops)),
        bound_ms=bytes_bound_ms(nbytes), bound_by="bytes",
    )
    print(f"synthetic_frames B={B} {H}x{W}x{frames} bfloat16, {int(ops[3].sum())} rows done: "
          f"kernel {timing['ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms (bytes; "
          f"{100 * timing['bound_ms'] / timing['ms']:.1f}% of it), plain version "
          f"{timing['plain_ms']:.4f} ms, the env's path without it (two _obs + where) "
          f"{timing['obs_obs_where_ms']:.4f} ms on {card}", flush=True)
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
    `frames` channels per frame; `net_options` select an act path of the
    network (`conv1_cache=True`, `ring_conv=True` or `ring_conv=False`; by
    default the ring conv wherever it takes the 1-channel bfloat16 ring)."""
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
    other act paths, which leave the fences to the learn step; with neither
    the network is asked for the fences (`ring_conv=False`), since its
    default takes the ring conv on a 1-channel bfloat16 ring. Returns the
    launch counts of the whole run and its env-steps/s."""
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    num_envs, steps_per_learn, learns_per_call = VIS_B, 8, 8
    net_options = {"conv1_cache": conv1_cache, "ring_conv": ring_conv}
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
    tag = f"visual runner, {frames}-channel frames" + "".join(
        f", {k}" for k, on in net_options.items() if on)
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
    42, within 300000 env steps). Returns the agent and its learner state:
    the offline IQL anchor's behaviour agent."""
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
    return agent, res.agent_state.learner


# Shorter windows for the replay-variant, history, safety and masked
# phases: the long ones cost tens of seconds under the profiler at the
# headline width and at these learns' sizes, and the script must stay
# within its time limit.
SHORT_STEPS, SHORT_LEARNS = (4, 20), (2, 6)


def kernels_per_step_and_learn(agent, env, astate, env_states, gen, num_envs, after_learn=None,
                               step_windows=(8, 72), learn_windows=(4, 20)):
    """The device kernels of one env step and of one learn, counted apart:
    each the difference of two profiled windows of different lengths (by
    default 8 and 72 steps, 4 and 20 learns), so that what a window's edges
    add or lose cancels. `after_learn(astate)` checks each learn's result.
    Returns (per step, per learn, step counts, learn counts, the state
    after)."""
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

    per_step, step_counts = per_unit(env_steps, *step_windows)
    per_learn, learn_counts = per_unit(learns, *learn_windows)
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


def start_ppo_learning():
    """`run_ppo_learning` and then phase 39's learning check
    (`run_population_learning`) in one child process (this script imported
    from its own directory), its output kept for `finish_ppo_learning`."""
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.exists(_population_learning_file()):
        os.unlink(_population_learning_file())
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; card = c.card_line(); "
         "c.run_ppo_learning(card); c.run_population_learning(card)"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def finish_ppo_learning(child, timeout_s=900):
    """Wait for `start_ppo_learning`'s child, print its output, fail if it
    failed, and return the learning population it saved."""
    out, _ = child.communicate(timeout=timeout_s)
    print(out.rstrip(), flush=True)
    assert child.returncode == 0, f"ppo or population learning failed ({child.returncode})"
    return torch.load(_population_learning_file(), weights_only=False)


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
# Timed dispatches of the summary and the sampled curves driver (5 until PR
# 13; the population phase times the summary driver again beside its
# members).
DRV_TIMED = 2


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


def driver_dispatcher(agent, astate, env_states, stats, deferred_push=False, seed=0, mesh=None):
    """One more dispatch of the headline driver, continuing from `astate`:
    the driver's own chunk program and device accounting, without the host
    fetch that `online_learning` makes after it. With a `mesh`, a rank's
    share of the envs, the learner averaging over the mesh's `data` axis and
    the statistics folded over it (an all-reduce), as
    `online_learning(mesh=...)` runs them. Returns dispatch() -> the
    dispatch's statistics tensor, left on the card."""
    from pearl_tpu_torch.envs import CartPole, VectorEnv
    from pearl_tpu_torch.parallel.data_parallel import with_pmean_axis
    from pearl_tpu_torch.training import online as online_mod
    from pearl_tpu_torch.utils import make_generator

    axis = None if mesh is None else mesh.axis("data")
    dev = torch.device("cuda") if axis is None else axis.device
    B = DRV_B if axis is None else DRV_B // axis.size
    env = CartPole()
    bound = (agent if axis is None else with_pmean_axis(agent, axis)).for_env(env)
    accounting = (online_mod._CurveStats(B, dev, B) if stats == "curves"
                  else {"summary": online_mod._SummaryStats,
                        "full": online_mod._FullStats}[stats](B, dev))
    chunk = online_mod._make_chunk_fn(bound, VectorEnv(env, B, dev), DRV_SPL, True, False,
                                      DRV_CPD, accounting, deferred_push)
    gen = make_generator(seed, dev)
    box = {"carry": (astate, env_states, torch.zeros(B, device=dev),
                     tuple(torch.zeros(B, device=dev) for _ in range(3)))}

    def dispatch():
        *carry, stats_dev = chunk(*box["carry"], gen)
        box["carry"] = tuple(carry)
        return stats_dev if axis is None else online_mod._fold_stats(stats_dev, stats, axis)

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
    warm, wall = timed_driver(agent, 1, seed=0, stats="summary")
    warm_wall = wall
    print(f"driver warm-up (1 dispatch, set-up included): {wall:.3f} s", flush=True)
    reset_fused_counts()
    res, wall = timed_driver(agent, DRV_TIMED, seed=1, stats="summary")
    counts = fused_counts()
    assert counts["by_body"] == driver_body_counts(DRV_TIMED), counts
    assert res.total_episodes > 0 and len(res.return_curve) == DRV_TIMED * DRV_CPD
    assert np.isfinite(res.return_curve).all() and res.mean_return >= 1.0, res.mean_return
    assert res.episode_returns.shape == (0,)
    sps = res.total_steps / wall
    print(f"driver (stats='summary'): {sps:.1f} env-steps/s over {DRV_TIMED} dispatches "
          f"({wall:.3f} s, "
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
    return {"sps": sps, "counts": counts, "profile": prof, "dispatch_s": dispatch_s,
            "warm_up": warm, "warm_up_wall": warm_wall}


def run_curves(card):
    """bench.py:343-407: the same agent and width with stats="curves": the
    sampled stream (curve_capacity 131072, 64 chunks per dispatch; a warm-up
    run of 1 dispatch and a timed one of 2) and the lossless configuration
    (1 chunk per dispatch: a warm-up run of 4 and a timed one of 20, which
    must drop no episode); one sampled dispatch under the sync check; and
    curves bit-equal to full on the card at 1024 envs over 3 dispatches."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning

    out = {}
    agent = headline_agent()
    for name, cpd, warm, timed in (("sampled", DRV_CPD, 1, DRV_TIMED), ("lossless", 1, 4, 20)):
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


def headline_runner(buffer=None, deferred_push=False):
    """`make_compiled_runner` of the headline agent (with `buffer` in place
    of its own, if given) at the headline width (bench.py:176-211),
    initialised and warmed up by one call. Returns [run_fn, astate,
    env_states, gen, agent]."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    agent = headline_agent()
    if buffer is not None:
        agent = dataclasses.replace(agent, replay_buffer=buffer)
    init_fn, run_fn = make_compiled_runner(
        agent, CartPole(), num_envs=DRV_B, steps_per_learn=DRV_SPL, learns_per_call=DRV_CPD,
        deferred_push=deferred_push,
    )
    astate, env_states = init_fn(0)
    gen = make_generator(0, "cuda")
    astate, env_states, _ = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    return [run_fn, astate, env_states, gen, agent]


def interleaved_calls(runners, order, card, label, reward_bounds=None):
    """One timed call of each runner in `order` (names into `runners`), B1's
    launches by body counted from 0 in each and held at one call's 512 act
    (tiled) and 128 learn (rows) launches; a call's reward sum within
    `reward_bounds` (by default CartPole's: 1 an env step). Returns (rates by
    name, counts by name: each runner's counts from its own last call)."""
    low, high = reward_bounds or (DRV_B * DRV_SPL * DRV_CPD,) * 2
    rates = {name: [] for name in runners}
    counts = {}
    for name in order:
        run_fn, astate, env_states, gen, _ = runners[name]
        reset_fused_counts()
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates[name].append(DRV_B * DRV_SPL * DRV_CPD / (time.perf_counter() - t0))
        counts[name] = fused_counts()
        assert counts[name]["by_body"] == driver_body_counts(1), (name, counts[name])
        assert low <= stats["reward_sum"].item() <= high, (name, stats["reward_sum"].item())
        runners[name][1:3] = [astate, env_states]
    print(f"{label} ({DRV_B} envs, {DRV_CPD} learns per call), env-steps/s in the order run: "
          + ", ".join(f"{n} {rates[n][order[:i + 1].count(n) - 1]:.1f}"
                      for i, n in enumerate(order))
          + "; B1 by body per call " + ", ".join(f"{n} {c['by_body']}" for n, c in counts.items())
          + f" on {card}", flush=True)
    return rates, counts


def run_deferred_runner(card):
    """`make_compiled_runner(deferred_push=True)` at the headline width (64
    learns per call) beside the per-step runner in the same phase: a warm-up
    call each, then timed calls in the order per-step, deferred, deferred,
    per-step; the two keep the same replay cursor and size and the same B1
    launches by body. Then one deferred dispatch of the driver under the
    sync check."""
    runners = {"per-step": headline_runner(), "deferred": headline_runner(deferred_push=True)}
    rates, counts = interleaved_calls(
        runners, ("per-step", "deferred", "deferred", "per-step"), card, "deferred runner")
    a, b = runners["per-step"][1].replay, runners["deferred"][1].replay
    assert (a.cursor, a.size) == (b.cursor, b.size), ((a.cursor, a.size), (b.cursor, b.size))
    index = b.storage.action_index
    assert ((index == 0) | (index == 1)).all()
    _, astate, env_states, _, agent = runners["deferred"]
    dispatch = driver_dispatcher(agent, astate, env_states, "full", deferred_push=True)
    stats_dev = no_sync(dispatch)
    assert stats_dev.shape == (4, DRV_SPL * DRV_CPD, DRV_B)
    print(f"deferred driver: one dispatch made no host sync on {card}", flush=True)
    return {"rates": rates, "counts": counts["deferred"]}


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


def runner_profiles(runners, names, card):
    """For each runner: the device kernels of one env step and of one learn
    (`kernels_per_step_and_learn`), then one more call profiled against the
    mean wall time of its timed calls (the idle share)."""
    from pearl_tpu_torch.envs import CartPole

    out = {}
    for name, wall_s in names.items():
        run_fn, astate, env_states, gen, agent = runners[name]
        per_step, per_learn, _, _, astate, env_states = kernels_per_step_and_learn(
            agent, CartPole(), astate, env_states, gen, DRV_B, step_windows=SHORT_STEPS,
            learn_windows=SHORT_LEARNS)
        prof = profile_fn(lambda: run_fn(astate, env_states, gen), wall_s,
                          unit=f"{name} runner call")
        runners[name][1:3] = [astate, env_states]
        print(f"{name} runner: {per_step:.1f} device kernels per env step, {per_learn:.1f} per "
              f"learn on {card}", flush=True)
        out[name] = {"kernels_per_step": per_step, "kernels_per_learn": per_learn,
                     "profile": prof}
    return out


def check_packed_equals_basic(card):
    """Packed and per-field storage give equal batches for the same indices,
    on the card at the runner's capacity: 16 pushes of 131072 random
    transitions (negative zeros, large and tiny floats, both bools, int32
    action indices), then 4096 drawn rows compared field by field, bit for
    bit."""
    from pearl_tpu_torch.replay_buffers import (
        BasicReplayBuffer, PackedReplayBuffer, TransitionBatch,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)

    def batch(n):
        f = lambda *shape: torch.randn(shape, device="cuda", generator=gen) * 1e3  # noqa: E731
        state = f(n, 4)
        state[::7, 0] = -0.0
        state[::11, 1] = 1e-30
        return TransitionBatch(
            state=state, action=torch.randint(0, 2, (n, 1), device="cuda", generator=gen).float(),
            reward=f(n), next_state=f(n, 4),
            terminated=torch.rand(n, device="cuda", generator=gen) < 0.5,
            truncated=torch.rand(n, device="cuda", generator=gen) < 0.1,
            action_index=torch.randint(-2**24, 2**24, (n,), device="cuda", generator=gen,
                                       dtype=torch.int32),
        )

    example = batch(1)
    bufs = {"basic": BasicReplayBuffer(capacity=DRV_CAPACITY),
            "packed": PackedReplayBuffer(capacity=DRV_CAPACITY)}
    states = {k: b.init(example) for k, b in bufs.items()}
    for _ in range(DRV_CAPACITY // DRV_B):
        data = batch(DRV_B)
        states = {k: bufs[k].push(states[k], data) for k in bufs}
    idx = bufs["basic"].sample_indices(states["basic"], gen, 4096)
    got = {k: bufs[k].sample(states[k], None, 4096, indices=idx) for k in bufs}
    for f in dataclasses.fields(got["basic"]):
        a, b = getattr(got["basic"], f.name), getattr(got["packed"], f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    print(f"packed and basic: equal batches for 4096 drawn rows of a {DRV_CAPACITY}-row ring "
          f"on {card}", flush=True)


def run_packed_runner(card):
    """bench.py:192-199's runner line with BENCH_BUFFER=packed: the headline
    agent storing into `PackedReplayBuffer(capacity=2_097_152)` beside the
    per-field runner of the same phase, a warm-up call each and timed calls
    in the order basic, packed, packed, basic; then the kernels of one env
    step and of one learn and a profiled call of each; then packed and basic
    batches compared for the same indices."""
    from pearl_tpu_torch.replay_buffers import PackedReplayBuffer

    runners = {"basic": headline_runner(),
               "packed": headline_runner(PackedReplayBuffer(capacity=DRV_CAPACITY))}
    rates, counts = interleaved_calls(runners, ("basic", "packed", "packed", "basic"), card,
                                      "packed runner")
    a, b = runners["basic"][1].replay, runners["packed"][1].replay
    assert (a.cursor, a.size) == (b.cursor, b.size), ((a.cursor, a.size), (b.cursor, b.size))
    walls = {n: DRV_B * DRV_SPL * DRV_CPD / statistics.mean(r) for n, r in rates.items()}
    profiles = runner_profiles(runners, walls, card)
    check_packed_equals_basic(card)
    return {"rates": rates, "counts": counts["packed"], "profiles": profiles}


def check_prioritized_draws(card):
    """The sampler's histogram over a small, fixed priority vector (7 rows
    written of 14; the others must never be drawn): Pearson's chi-square over
    the 7 written rows, 6 degrees of freedom, below 22.46 (its 0.001
    critical value) for 1048576 draws on the card."""
    from pearl_tpu_torch.replay_buffers import PrioritizedReplayBuffer, TransitionBatch

    buf = PrioritizedReplayBuffer(capacity=14)
    z = torch.zeros((7, 1), device="cuda")
    rows = TransitionBatch(state=z, action=z, reward=z[:, 0], next_state=z,
                           terminated=z[:, 0] > 0, truncated=z[:, 0] > 0)
    state = buf.push(buf.init(rows), rows)
    p = torch.tensor([0.01, 0.5, 1.0, 2.0, 4.0, 8.0, 1e-6], device="cuda")
    state.priorities[:7].copy_(p)
    draws = 1 << 20
    idx = buf.sample_indices(state, torch.Generator(device="cuda").manual_seed(0), draws)
    counts = torch.bincount(idx, minlength=14).cpu().double()
    w = torch.clamp(p.cpu().double(), min=buf.epsilon) ** buf.alpha
    expected = draws * w / w.sum()
    chi2 = float(((counts[:7] - expected) ** 2 / expected).sum())
    assert counts[7:].sum() == 0 and chi2 < 22.46, (chi2, counts.tolist(), expected.tolist())
    print(f"prioritized draws: chi-square {chi2:.3f} over 7 rows (bound 22.46, 6 degrees of "
          f"freedom, p = 0.001), {draws} draws on {card}", flush=True)
    return chi2


def check_priority_write_back(runner):
    """One more learn on drawn indices: the priorities of the drawn rows are
    then |td| + epsilon, the td of the learn's own batch before its update
    (a repeated row takes its last occurrence's)."""
    from pearl_tpu_torch.replay_buffers.prioritized import last_occurrence_values

    run_fn, astate, env_states, gen, agent = runner
    buf, learner = agent.replay_buffer, agent.policy_learner
    idx = buf.sample_indices(astate.replay, gen, learner.batch_size)
    batch = buf.sample(astate.replay, None, learner.batch_size, indices=idx)
    with torch.no_grad():
        _, aux = learner.td_loss(astate.learner, batch)
    want = last_occurrence_values(idx, aux["per_sample_td"] + buf.epsilon)
    astate, _ = agent.learn(astate, gen, indices=idx[None])
    got = astate.replay.priorities[idx]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    runner[1] = astate
    return int(idx.unique().numel())


def run_prioritized_runner(card):
    """The headline runner with `PrioritizedReplayBuffer(capacity=2_097_152)`
    beside the per-field runner of the same phase (basic, prioritized,
    prioritized, basic), B1's launches per call; one call under the sync
    check; the write-back of one learn; the kernels of one env step and of
    one learn and a profiled call of the prioritized runner (the idle share;
    the per-field runner's are phase 17's); the draws' histogram."""
    from pearl_tpu_torch.replay_buffers import PrioritizedReplayBuffer

    runners = {"basic": headline_runner(),
               "prioritized": headline_runner(PrioritizedReplayBuffer(capacity=DRV_CAPACITY))}
    rates, counts = interleaved_calls(
        runners, ("basic", "prioritized", "prioritized", "basic"), card, "prioritized runner")
    run_fn, astate, env_states, gen, _ = runners["prioritized"]
    astate, env_states, _ = no_sync(lambda: run_fn(astate, env_states, gen))
    runners["prioritized"][1:3] = [astate, env_states]
    p = astate.replay.priorities[:astate.replay.size]
    assert torch.isfinite(p).all() and (p > 0).all() and (p != 1.0).any()
    print(f"prioritized runner: one call made no host sync; priorities of the {p.numel()} "
          f"written rows in [{p.min().item():.6f}, {p.max().item():.6f}] on {card}", flush=True)
    rows = check_priority_write_back(runners["prioritized"])
    print(f"prioritized runner: one more learn wrote |td| + epsilon to its {rows} distinct "
          f"drawn rows on {card}", flush=True)
    walls = {"prioritized": DRV_B * DRV_SPL * DRV_CPD / statistics.mean(rates["prioritized"])}
    profiles = runner_profiles(runners, walls, card)
    chi2 = check_prioritized_draws(card)
    return {"rates": rates, "counts": counts["prioritized"], "profiles": profiles, "chi2": chi2}


# The two BootstrappedDQN rows of the reference's registry
# (pearl_tpu/benchmarks/configs.py:132-139, 293-303): K = 10 and K = 1, batch
# 128, two rounds, a learn every 4 steps; 1024 envs; the registry's 50000-row
# replay rounded up to a multiple of 1024.
BOOT_B, BOOT_SPL, BOOT_LPC, BOOT_CAPACITY = 1_024, 4, 32, 65_536


def run_bootstrapped(card):
    """Bootstrapped DQN at both registry rows through the runner: a warm-up
    and a timed call of 32 learns each (64 learns), the priors bit-identical
    afterwards while the trainable members moved, the stored masks' mean
    within 5 standard deviations of p, the losses of one more learn finite;
    then 16 env steps through the agent, in which z changes only where an
    episode ended."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole, VectorEnv
    from pearl_tpu_torch.neural_networks import EnsembleQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import BootstrappedDQN
    from pearl_tpu_torch.replay_buffers import BootstrapReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    env = CartPole()
    out = {}
    for K in (10, 1):
        name = f"bootstrapped dqn K={K}"
        agent = PearlAgent(
            policy_learner=BootstrappedDQN(q_network=EnsembleQValueNetwork(ensemble_size=K),
                                           training_rounds=2, batch_size=128),
            replay_buffer=BootstrapReplayBuffer(capacity=BOOT_CAPACITY, ensemble_size=K),
        )
        init_fn, run_fn = make_compiled_runner(agent, env, num_envs=BOOT_B,
                                               steps_per_learn=BOOT_SPL, learns_per_call=BOOT_LPC)
        astate, env_states = init_fn(0)
        gen = make_generator(0, "cuda")
        prior = [p.clone() for p in astate.learner.prior_params.parameters()]
        params = [p.clone() for p in astate.learner.params.parameters()]
        rates = []
        for _ in range(2):  # a warm-up and a timed call: 64 learns
            t0 = time.perf_counter()
            astate, env_states, stats = run_fn(astate, env_states, gen)
            torch.cuda.synchronize()
            rates.append(BOOT_B * BOOT_SPL * BOOT_LPC / (time.perf_counter() - t0))
        assert stats["reward_sum"].item() == BOOT_B * BOOT_SPL * BOOT_LPC
        assert all(torch.equal(a, b) for a, b in zip(prior, astate.learner.prior_params.parameters()))
        assert all(not torch.equal(a, b) for a, b in zip(params, astate.learner.params.parameters()))
        replay = astate.replay
        mask = replay.storage.bootstrap_mask[:replay.size]
        p = agent.replay_buffer.p
        bound = 5 * math.sqrt(p * (1 - p) / mask.numel())
        mean = mask.mean().item()
        assert abs(mean - p) < bound and set(mask.unique().tolist()) == {0.0, 1.0}, (mean, bound)
        astate = check_learn_metrics(agent, env, astate, gen, name)

        bound_agent = agent.for_env(env)
        venv = VectorEnv(env, BOOT_B, torch.device("cuda"))
        moved_total = finished = 0
        for _ in range(16):
            z = astate.learner.explore_state.z.clone()
            astate, choice = bound_agent.act(astate, gen)
            env_states, result, next_obs = venv.step(env_states, choice.action, gen)
            astate = bound_agent.observe(astate, result, next_obs, gen)
            moved = astate.learner.explore_state.z != z
            assert not (moved & ~result.done).any()
            moved_total += int(moved.sum())
            finished += int(result.done.sum())
        z = astate.learner.explore_state.z
        assert z.dtype == torch.int64 and ((z >= 0) & (z < K)).all()
        print(f"{name} runner ({BOOT_B} CartPole envs, capacity {BOOT_CAPACITY}): env-steps/s "
              f"warm-up {rates[0]:.1f}, timed {rates[1]:.1f}; priors bit-identical after "
              f"{2 * BOOT_LPC} learns, members moved; mask mean {mean:.5f} (p {p}, bound "
              f"{bound:.5f}); over 16 steps z changed for {moved_total} of {finished} finished "
              f"episodes and nowhere else on {card}", flush=True)
        out[name] = {"rates": rates, "mask_mean": mean}
    return out


# HER's budget: the reference's 150000 env steps cut to 20000 (the success
# share was 0.725 over the first 200 episodes and 1.000 over the last 200 of
# 150000 steps on the H100).
HER_STEPS = 20_000


def run_her_learning(card):
    """tests/integration/test_convergence.py:193-219 on the card: DQN with
    HER on the 8-direction sparse reach task, 16 envs, HER_STEPS env steps
    (the reference: 150000), seed 42; the success share of the last 200
    episodes must be above 0.95 and above that of the first 200."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import DiscreteSparseRewardEnvironment
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import HindsightExperienceReplayBuffer
    from pearl_tpu_torch.training import online_learning

    env = DiscreteSparseRewardEnvironment(length=50.0, num_actions=8, step_size=4.0,
                                          reward_distance=4.0, max_steps=40)
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=4, batch_size=128,
                                     exploration=EGreedyExploration(epsilon=0.1)),
        replay_buffer=HindsightExperienceReplayBuffer(capacity=100_000, num_envs=16,
                                                      max_episode_len=40, goal_dim=2),
    )
    t0 = time.perf_counter()
    res = online_learning(agent, env, num_envs=16, max_steps=HER_STEPS, learn_every_k_steps=2,
                          learning_starts=1_000, seed=42)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    success = res.episode_returns > -40.0 + 0.5
    last, first = float(success[-200:].mean()), float(success[:200].mean())
    replay = res.agent_state.replay
    print(f"her learning: success share {last:.3f} over the last 200 episodes ({first:.3f} "
          f"over the first 200), {len(success)} episodes in {res.total_steps} env steps, "
          f"{seconds:.1f} s; replay size {replay.size.item()} of {agent.replay_buffer.capacity} "
          f"on {card}", flush=True)
    assert last > 0.95 and first < last, (first, last)
    return {"success_last_200": last, "seconds": seconds}


def run_two_tower_and_tabular(card):
    """One short runner call each: DQN with `TwoTowerQValueNetwork` at 1024
    CartPole envs, and `TabularQLearning` at 16 envs (a state's index is the
    argmax of its observation, 4 states here; a smoke of the card path, not a
    learning task); the losses of one more learn finite."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import TwoTowerQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        DeepQLearning, TabularQLearning,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    env = CartPole()
    cases = {
        "two-tower dqn": (PearlAgent(
            policy_learner=DeepQLearning(q_network=TwoTowerQValueNetwork(), training_rounds=1,
                                         batch_size=1024),
            replay_buffer=BasicReplayBuffer(capacity=8 * 16 * 1024)), 1024, 16),
        "tabular q": (PearlAgent(
            policy_learner=TabularQLearning(num_states=4, learning_rate=0.5),
            replay_buffer=BasicReplayBuffer(capacity=16)), 16, 64),
    }
    out = {}
    for name, (agent, n, lpc) in cases.items():
        spl = 8 if name == "two-tower dqn" else 1
        init_fn, run_fn = make_compiled_runner(agent, env, num_envs=n, steps_per_learn=spl,
                                               learns_per_call=lpc)
        astate, env_states = init_fn(0)
        gen = make_generator(0, "cuda")
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rate = spl * lpc * n / (time.perf_counter() - t0)
        assert stats["reward_sum"].item() == spl * lpc * n
        astate = check_learn_metrics(agent, env, astate, gen, name)
        if name == "tabular q":
            q = astate.learner.q_table
            assert torch.isfinite(q).all() and (q != 0).any()
        print(f"{name} runner ({n} CartPole envs): {rate:.1f} env-steps/s, the first call "
              f"on {card}", flush=True)
        out[name] = rate
    return out


# Item 16, history and safety: the history runners at 1024 envs with the
# bootstrapped phase's replay, the reward-constrained learners at the
# registry's 16 envs. `DEV` is the card.
DEV = "cuda"
HIST_B, HIST_CAPACITY = 1_024, 65_536
LSTM_ANCHOR = dict(num_envs=32, max_steps=100_000, learn_every_k_steps=4, learning_starts=2_000,
                   seed=7)
RC_B, RC_LPC, RC_CALLS = 16, 250, 2


def partial_cartpole():
    """CartPole that shows positions only (tests/test_wrappers_and_history.py:
    106-134; the reference's PartialObservableCartPole)."""
    from pearl_tpu_torch.envs import CartPole, PartialObservabilityWrapper

    return PartialObservabilityWrapper(env=CartPole(), observed_indices=(0, 2))


def lstm_summarizer():
    from pearl_tpu_torch.history_summarization_modules import LSTMHistorySummarization

    # The registry's LSTM rows (pearl_tpu/benchmarks/configs.py:197-256).
    return LSTMHistorySummarization(history_length=8, hidden_dim=64, num_layers=1)


def history_dqn(summarizer, capacity=HIST_CAPACITY):
    """DQN at the registry's LSTMDQN row (configs.py:197-210: 2 rounds of
    128, the ε schedule 0.5 -> 0.05 over 20000 steps) with `summarizer`."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    return PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2, batch_size=128, history_summarizer=summarizer,
            exploration=EGreedyExploration(start_epsilon=0.5, end_epsilon=0.05,
                                           warmup_steps=20_000),
        ),
        replay_buffer=BasicReplayBuffer(capacity=capacity),
    )


def learn_moves_summarizer(agent, env, astate, gen, name, learns=4):
    """`learns` learns one at a time, the first under the sync check: every
    trainable tensor of the summarizer must change in each, every loss be
    finite. Returns the state after."""
    bound = agent.for_env(env)
    for i in range(learns):
        params = astate.learner.summarizer_params
        before = [p.detach().clone() for p in params.parameters()]
        if i == 0:
            astate, metrics = no_sync(lambda: bound.learn(astate, gen))
        else:
            astate, metrics = bound.learn(astate, gen)
        moved = [not torch.equal(a, b) for a, b in zip(params.parameters(), before)]
        values = {k: v.item() for k, v in metrics.items()}
        assert all(moved) and moved, (name, moved)
        assert all(math.isfinite(v) for v in values.values()), (name, values)
    print(f"{name}: the summarizer's {len(moved)} tensors moved in each of {learns} learns "
          "(the first under the sync check); " + ", ".join(f"{k}={v:.6f}" for k, v in values.items()),
          flush=True)
    return astate


def history_runner(agent, env, name, card, spl, lpc, calls=2, learn_windows=SHORT_LEARNS):
    """`make_compiled_runner` at 1024 envs: a warm-up call, `calls` timed
    ones (the last under the sync check: a call reads nothing back), a
    profiled call, and the device kernels of one env step and of one learn.
    Returns (runner state list, the measurements)."""
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    num_envs = HIST_B
    init_fn, run_fn = make_compiled_runner(agent, env, num_envs=num_envs, steps_per_learn=spl,
                                           learns_per_call=lpc)
    astate, env_states = init_fn(0)
    gen = make_generator(0, DEV)
    per_call = spl * lpc * num_envs
    astate, env_states, stats = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    rates = []
    for c in range(calls):
        t0 = time.perf_counter()
        if c == calls - 1:
            astate, env_states, stats = no_sync(lambda: run_fn(astate, env_states, gen))
        else:
            astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates.append(per_call / (time.perf_counter() - t0))
    reward_sum = stats["reward_sum"].item()
    assert math.isfinite(reward_sum) and stats["episodes"].item() >= 0
    wall = per_call / statistics.mean(rates)
    prof = profile_fn(lambda: run_fn(astate, env_states, gen), wall, unit=f"{name} call")
    per_step, per_learn, _, _, astate, env_states = kernels_per_step_and_learn(
        agent, env, astate, env_states, gen, num_envs, step_windows=SHORT_STEPS,
        learn_windows=learn_windows)
    print(f"{name} runner ({num_envs} envs, {spl} steps a learn, {lpc} learns a call): "
          f"env-steps/s " + ", ".join(f"{r:.1f}" for r in rates)
          + f" (the last call under the sync check); {per_step:.1f} device kernels per env "
          f"step, {per_learn:.1f} per learn on {card}", flush=True)
    return [run_fn, astate, env_states, gen], {
        "rates": rates, "kernels_per_step": per_step, "kernels_per_learn": per_learn,
        "profile": prof}


def stacking_visual_agent(num_envs):
    """bench.py:232-274 with BENCH_CNN_LEGACY=1: the stacking summarizer over
    observations, float32 frames from the env, a bfloat16 replay of two
    frames a row, bfloat16 acting."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import SyntheticAtari
    from pearl_tpu_torch.history_summarization_modules import StackingHistorySummarization
    from pearl_tpu_torch.neural_networks import CNNQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import VisualReplayBuffer

    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(input_shape=(VIS_H, VIS_W, VIS_T), time_major_stack=True),
            training_rounds=1, batch_size=VIS_LEARN_B, act_dtype="bfloat16",
            history_summarizer=StackingHistorySummarization(history_length=VIS_T,
                                                            include_action=False),
        ),
        replay_buffer=VisualReplayBuffer(capacity=8 * num_envs, stack=VIS_T, num_envs=num_envs,
                                         frame_dtype=torch.bfloat16, dedup_next=False),
    )
    return agent, SyntheticAtari(frames=1)


def run_stacking_visual(card):
    """The stacking visual runner (bench.py's BENCH_CNN_LEGACY=1) beside the
    default frame-ring runner, a warm-up call each, then timed calls in the
    order ring, stacking, stacking, ring (8 steps a learn, 8 learns a call):
    the stacking runner launches no frame kernel. Then the oracle: the ring
    runner's window, materialised, through the stacking path gives the ring
    path's Q values (float32: 1e-4, cuDNN sums the rolled channels in another
    order; the bfloat16 act path: 3e-2) and its greedy actions wherever the
    best two differ by more than that."""
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    spl = lpc = 8
    runners = {}
    for name, (agent, env) in (("ring", visual_agent(VIS_B, 1, VIS_LEARN_B)),
                               ("stacking", stacking_visual_agent(VIS_B))):
        init_fn, run_fn = make_compiled_runner(agent, env, num_envs=VIS_B, steps_per_learn=spl,
                                               learns_per_call=lpc)
        astate, env_states = init_fn(0)
        gen = make_generator(0, DEV)
        astate, env_states, _ = run_fn(astate, env_states, gen)  # warm-up
        runners[name] = [run_fn, astate, env_states, gen, agent, env]
    torch.cuda.synchronize()
    wrappers = visual_wrappers()
    rates = {name: [] for name in runners}
    launches = {}
    for name in ("ring", "stacking", "stacking", "ring"):
        run_fn, astate, env_states, gen, _, _ = runners[name]
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        astate, env_states, stats = run_fn(astate, env_states, gen)
        torch.cuda.synchronize()
        rates[name].append(spl * lpc * VIS_B / (time.perf_counter() - t0))
        launches[name] = {k: fn.launches for k, fn in wrappers.items()}
        runners[name][1:3] = [astate, env_states]
        assert 0 <= stats["reward_sum"].item() <= spl * lpc * VIS_B
    assert sum(launches["stacking"].values()) == 0, launches["stacking"]
    assert launches["ring"]["ring_write_where"] == spl * lpc, launches["ring"]

    from pearl_tpu_torch.history_summarization_modules import FrameRingView

    _, ring_state, _, _, ring_agent, ring_env = runners["ring"]
    _, stack_state, _, _, stack_agent, stack_env = runners["stacking"]
    ring_learner = ring_agent.for_env(ring_env).policy_learner
    stack_learner = stack_agent.for_env(stack_env).policy_learner
    view = ring_state.history_carry
    window = view.materialize().float()
    params = ring_state.learner.params
    with torch.no_grad():
        q_ring = ring_learner.q_network.q_all(
            params, FrameRingView(view.ring.float(), view.valid, view.cursor), None)
        q_stack = stack_learner.q_network.q_all(params, window, None)
        torch.testing.assert_close(q_stack, q_ring, rtol=1e-4, atol=1e-4)
        # The act path (bfloat16) of each learner, on the ring learner's state.
        s_ring = ring_learner._scores(ring_state.learner, view, None)
        s_stack = stack_learner._scores(ring_state.learner, window, None)
    torch.testing.assert_close(s_stack, s_ring, rtol=0, atol=3e-2)
    for q, s, tol in ((q_ring, q_stack, 1e-4), (s_ring, s_stack, 3e-2)):
        top2 = q.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        assert torch.equal(q.argmax(-1)[clear], s.argmax(-1)[clear])
        agree = int(clear.sum())
    ratio = statistics.mean(rates["stacking"]) / statistics.mean(rates["ring"])
    print(f"stacking visual runner ({VIS_B} envs, 84x84, a window of {VIS_T}), env-steps/s in "
          f"the order run: ring {rates['ring'][0]:.1f}, stacking {rates['stacking'][0]:.1f}, "
          f"stacking {rates['stacking'][1]:.1f}, ring {rates['ring'][1]:.1f} (stacking / ring "
          f"{ratio:.3f}); ring launches per call {launches['ring']}, stacking none; oracle: Q "
          f"within {(q_stack - q_ring).abs().max().item():.3e} (float32) and "
          f"{(s_stack - s_ring).abs().max().item():.3e} (bfloat16 act), greedy actions equal on "
          f"the {agree} envs whose best two differ by more than 6e-2 on {card}", flush=True)
    run_fn, astate, env_states, gen, _, _ = runners["stacking"]
    profile_fn(lambda: run_fn(astate, env_states, gen),
               spl * lpc * VIS_B / statistics.mean(rates["stacking"]),
               unit="stacking visual runner call")
    return {"rates": rates, "ratio": ratio, "ring_launches": launches["ring"]}


def run_lstm_dqn(card):
    """The registry's LSTMDQN row (configs.py:197-210) on positions-only
    CartPole at 1024 envs (a learn every 4 steps, 16 learns a call; replay
    65536 rows); the summarizer moves in every learn; then the reference's
    learning anchor (tests/test_wrappers_and_history.py:106-134: 32 envs,
    100000 env steps, seed 7, the mean return of the last tenth of the
    episodes above 100)."""
    from pearl_tpu_torch.training import online_learning

    env = partial_cartpole()
    agent = history_dqn(lstm_summarizer())
    state, out = history_runner(agent, env, "lstm dqn", card, spl=4, lpc=16)
    assert state[1].replay.storage.state.shape[-1] == 8 * (2 + 2)
    learn_moves_summarizer(agent, env, state[1], state[3], "lstm dqn")

    t0 = time.perf_counter()
    res = online_learning(history_dqn(lstm_summarizer(), capacity=50_000), env, **LSTM_ANCHOR)
    seconds = time.perf_counter() - t0
    r = np.asarray(res.episode_returns)
    n = max(len(r) // 10, 20)
    last, first = float(r[-n:].mean()), float(r[:n].mean())
    print(f"lstm dqn learning: mean return {first:.1f} over the first tenth of {len(r)} "
          f"episodes, {last:.1f} over the last, after {res.total_steps} env steps in "
          f"{seconds:.1f} s on {card}", flush=True)
    assert last > 100.0, (first, last)
    out.update(anchor_last_tenth=last, anchor_seconds=seconds)
    return out


def run_transformer_dqn(card):
    """tests/test_risk_sensitive_and_transformer.py:139-170's learner (d 64,
    one layer, 4 heads, a window of 8) on positions-only CartPole at 1024
    envs, as the LSTM's runner; the summarizer moves in every learn."""
    from pearl_tpu_torch.history_summarization_modules import TransformerHistorySummarization

    env = partial_cartpole()
    agent = history_dqn(TransformerHistorySummarization(history_length=8, dim=64, num_layers=1,
                                                        num_heads=4))
    state, out = history_runner(agent, env, "transformer dqn", card, spl=4, lpc=16)
    learn_moves_summarizer(agent, env, state[1], state[3], "transformer dqn")
    return out


def run_lstm_actor_critic(card):
    """The registry's LSTMPPO (configs.py:222-238: a rollout of 16, 20 rounds
    of 64, clip 0.1, learning rates 1e-4) and LSTMSAC (:239-256: discrete
    SAC, 2 rounds of 100, entropy 0.01 fixed, a learn every 4 steps) rows on
    positions-only CartPole at 1024 envs: the summarizer moves under the sum
    of the actor's and the critic's gradients, every loss finite."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ProximalPolicyOptimization, SoftActorCritic,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, OnPolicyReplayBuffer

    env = partial_cartpole()
    ppo = PearlAgent(
        policy_learner=ProximalPolicyOptimization(
            training_rounds=20, batch_size=64, epsilon=0.1, actor_learning_rate=1e-4,
            critic_learning_rate=1e-4, history_summarizer=lstm_summarizer()),
        replay_buffer=OnPolicyReplayBuffer(capacity=16 * HIST_B, num_envs=HIST_B),
    )
    sac = PearlAgent(
        policy_learner=SoftActorCritic(
            training_rounds=2, batch_size=100, entropy_coef=0.01, entropy_autotune=False,
            actor_learning_rate=1e-3, critic_learning_rate=1e-3,
            history_summarizer=lstm_summarizer()),
        replay_buffer=BasicReplayBuffer(capacity=HIST_CAPACITY),
    )
    out = {}
    # A PPO learn is 20 rounds (about 4000 kernels): count over 1 and 2.
    state, out["lstm ppo"] = history_runner(ppo, env, "lstm ppo", card, spl=16, lpc=2,
                                            learn_windows=(1, 2))
    # A whole rollout, then one learn under the checks (the buffer is empty
    # after every learn).
    astate = fill_rollout(ppo, env, state[1], state[2], state[3], HIST_B, 16)
    learn_moves_summarizer(ppo, env, astate, state[3], "lstm ppo", learns=1)
    state, out["lstm sac"] = history_runner(sac, env, "lstm sac", card, spl=4, lpc=16)
    learn_moves_summarizer(sac, env, state[1], state[3], "lstm sac")
    return out


def rc_agent(learner, buffer=None):
    """The registry's `_rc_agent` (configs.py:527-537) at constraint 0.2."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.safety_modules import RCSafetyModuleCostCriticContinuousAction

    return PearlAgent(
        policy_learner=learner,
        replay_buffer=buffer if buffer is not None else BasicReplayBuffer(capacity=50_000),
        safety_module=RCSafetyModuleCostCriticContinuousAction(constraint_value=0.2,
                                                               batch_size=256),
        store_cost=True,
    )


def rc_drive(agent, env, astate, gen, rows=4096):
    """E[max(Q_c1, Q_c2)] * (1 - gamma_c) at `rows` replay states and the
    policy's actions there: what lambda's update holds against the
    constraint (lambda rises while it is above)."""
    bound = agent.for_env(env)
    module, learner, ls = bound.safety_module, bound.policy_learner, astate.learner
    batch = bound.replay_buffer.sample(astate.replay, gen, rows)
    with torch.no_grad():
        subj = learner.history_summarizer.forward(ls.summarizer_params, batch.state)
        action = module._policy_action(learner, ls, subj, astate.safety.generator, None)
        q1, q2 = module._critic().q_both(astate.safety.critic_params, subj, action)
        return (torch.maximum(q1, q2).mean() * (1.0 - module.cost_discount_factor)).item()


def rc_lambda_rises(agent, env, astate, gen, updates=10):
    """With the constraint at 0, lambda's drive is the cost estimate itself:
    `updates` module updates from replay must raise lambda from 0, within
    its box. The agent's own run keeps its constraint."""
    bound = agent.for_env(env)
    module = dataclasses.replace(bound.safety_module, constraint_value=0.0)
    state = dataclasses.replace(astate.safety, lagrangian=torch.zeros((), device=DEV))
    for _ in range(updates):
        state, _ = module.learn(state, bound.replay_buffer, astate.replay, gen,
                                bound.policy_learner, astate.learner)
    lam = state.lagrangian.item()
    assert 0.0 < lam <= module.lambda_constraint_ub_value, lam
    return f"at constraint 0, {updates} updates raise lambda from 0 to {lam:.6f}"


def run_rc(card):
    """RCCSAC (configs.py:401-408) on the safety suite's Pendulum with its
    torque cost (configs.py:775-784) at 16 envs, beside CSAC without the
    module on the same env: one learn a step, 250 a call, 3 calls; lambda
    after each call, the mean episode cost (200 steps an episode, from the
    costs in replay) and the return; one learn under the sync check. Then
    RCPPO (configs.py:417-426: 8 rounds of 256, a rollout of 128) on CartPole
    whose risky half is x > 0, the discrete one-hot path."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole, Pendulum, SafetyWrapper
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ContinuousSoftActorCritic, ProximalPolicyOptimization,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, OnPolicyReplayBuffer
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    env = Pendulum(emit_torque_cost=True)
    out = {}
    for name in ("csac", "rc csac"):
        learner = ContinuousSoftActorCritic(training_rounds=1, batch_size=256)
        agent = rc_agent(learner)
        if name == "csac":  # the same agent without the module; costs still stored
            agent = PearlAgent(policy_learner=learner, replay_buffer=BasicReplayBuffer(50_000),
                               store_cost=True)
        init_fn, run_fn = make_compiled_runner(agent, env, num_envs=RC_B, steps_per_learn=1,
                                               learns_per_call=RC_LPC)
        astate, env_states = init_fn(0)
        gen = make_generator(0, DEV)
        lambdas, returns, costs = [], [], []
        t0 = time.perf_counter()
        for _ in range(RC_CALLS):
            astate, env_states, stats = run_fn(astate, env_states, gen)
            episodes = stats["episodes"].item()
            returns.append(stats["reward_sum"].item() / max(episodes, 1))
            replay = astate.replay
            recent = replay.storage.cost[max(replay.cursor - RC_LPC * RC_B, 0):replay.cursor]
            costs.append(200.0 * recent.mean().item())
            if name == "rc csac":
                lambdas.append(astate.safety.lagrangian.item())
        seconds = time.perf_counter() - t0
        assert replay.storage.cost.max().item() > 0.0
        astate, metrics = no_sync(lambda: agent.for_env(env).learn(astate, gen))
        values = {k: v.item() for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
        drive = ""
        if name == "rc csac":
            assert all(0.0 <= lam <= 20.0 for lam in lambdas), lambdas
            assert all(torch.isfinite(p).all() for p in astate.safety.critic_params.parameters())
            drive = (f"; the constraint's left side now {rc_drive(agent, env, astate, gen):.4f}"
                     f"; {rc_lambda_rises(agent, env, astate, gen)}")
        print(f"{name} ({RC_B} Pendulum envs with torque cost, {RC_CALLS} calls of {RC_LPC} "
              f"steps, a learn a step, {seconds:.1f} s): lambda after each call "
              f"{[round(x, 6) for x in lambdas]}, mean episode cost {[round(c, 3) for c in costs]}"
              f", mean episode return {[round(r, 1) for r in returns]}{drive}; one learn made no "
              "host sync: " + ", ".join(f"{k}={v:.6f}" for k, v in values.items())
              + f" on {card}", flush=True)
        out[name] = {"lambda": lambdas, "episode_cost": costs, "episode_return": returns,
                     "seconds": seconds}

    safety_env = SafetyWrapper(env=CartPole(), risky_fn=lambda o, a: o[:, 0] > 0)
    agent = rc_agent(ProximalPolicyOptimization(training_rounds=8, batch_size=256),
                     buffer=OnPolicyReplayBuffer(capacity=128 * RC_B, num_envs=RC_B))
    init_fn, run_fn = make_compiled_runner(agent, safety_env, num_envs=RC_B, steps_per_learn=128,
                                           learns_per_call=1, learn=False)
    astate, env_states = init_fn(0)
    gen = make_generator(0, DEV)
    lambdas = []
    for _ in range(4):  # a rollout, then a learn (the module's update before the clear)
        astate, env_states, _ = run_fn(astate, env_states, gen)
        cost = astate.replay.storage.cost
        assert cost.max().item() == 1.0 and cost.min().item() == 0.0
        astate, metrics = agent.for_env(safety_env).learn(astate, gen)
        lambdas.append(astate.safety.lagrangian.item())
        assert all(math.isfinite(v.item()) for v in metrics.values())
    assert all(0.0 <= lam <= 20.0 for lam in lambdas), lambdas
    print(f"rc ppo ({RC_B} CartPole envs, risky x > 0, rollouts of 128): lambda after each of "
          f"4 learns {[round(x, 6) for x in lambdas]}, losses finite on {card}", flush=True)
    out["rc ppo"] = {"lambda": lambdas}
    return out


def run_masked_headline(card, plain):
    """bench.py:176-211's headline runner on DynamicActionSpaceWrapper(
    CartPole(), interval 4, num_masked 1) (configs.py:725-727) with
    `track_available_masks=True`, beside the plain headline runner: a
    warm-up call each, timed calls in the order plain, masked, masked,
    plain, B1 at 512 tiled + 128 rows launches a call on both; every stored
    action was available at act time; then the kernels and a profiled call
    of the masked runner, set against `plain`, phase 17's of the same plain
    runner (the two (131072, 2) bool columns' card time is the difference of
    busy time)."""
    from pearl_tpu_torch.envs import CartPole, DynamicActionSpaceWrapper
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    masked_env = DynamicActionSpaceWrapper(env=CartPole(), interval=4, num_masked=1)
    agent = dataclasses.replace(headline_agent(), track_available_masks=True)
    init_fn, run_fn = make_compiled_runner(agent, masked_env, num_envs=DRV_B,
                                           steps_per_learn=DRV_SPL, learns_per_call=DRV_CPD)
    astate, env_states = init_fn(0)
    gen = make_generator(0, DEV)
    astate, env_states, _ = run_fn(astate, env_states, gen)  # warm-up
    torch.cuda.synchronize()
    runners = {"plain": headline_runner(), "masked": [run_fn, astate, env_states, gen, agent]}
    rates, counts = interleaved_calls(runners, ("plain", "masked", "masked", "plain"), card,
                                      "masked headline runner")
    replay = runners["masked"][1].replay
    size = replay.size
    curr = replay.storage.curr_available_mask[:size]
    nxt = replay.storage.next_available_mask[:size]
    index = replay.storage.action_index[:size].long()
    chosen = curr.gather(1, index[:, None])[:, 0]
    assert chosen.all(), int((~chosen).sum())
    hidden = int((~nxt[:, 1]).sum())
    assert hidden > 0 and nxt[:, 0].all()
    walls = {n: DRV_B * DRV_SPL * DRV_CPD / statistics.mean(r) for n, r in rates.items()}
    profiles = {"plain": plain}
    run_fn, astate, env_states, gen, _ = runners["masked"]
    per_step, per_learn, _, _, astate, env_states = kernels_per_step_and_learn(
        agent, masked_env, astate, env_states, gen, DRV_B, step_windows=SHORT_STEPS,
        learn_windows=SHORT_LEARNS)
    prof = profile_fn(lambda: run_fn(astate, env_states, gen), walls["masked"],
                      unit="masked headline runner call")
    profiles["masked"] = {"kernels_per_step": per_step, "kernels_per_learn": per_learn,
                          "profile": prof}
    ratio = statistics.mean(rates["masked"]) / statistics.mean(rates["plain"])
    busy = [profiles[n]["profile"]["busy_ms"] if profiles[n]["profile"] else float("nan")
            for n in ("plain", "masked")]
    print(f"masked headline runner: masked / plain env-steps/s {ratio:.3f}; every one of "
          f"{size} stored actions was available at act time ({hidden} next states hid action "
          f"1); device kernels per env step {profiles['plain']['kernels_per_step']:.1f} -> "
          f"{profiles['masked']['kernels_per_step']:.1f}, per learn "
          f"{profiles['plain']['kernels_per_learn']:.1f} -> "
          f"{profiles['masked']['kernels_per_learn']:.1f}; busy {busy[0]:.3f} -> {busy[1]:.3f} "
          f"ms a call (the mask columns and the mask's kernels: {busy[1] - busy[0]:.3f} ms) on "
          f"{card}", flush=True)
    return {"rates": rates, "ratio": ratio, "counts": counts["masked"], "profiles": profiles}


def kernels_per_call(fn, short=4, long=20):
    """The device kernels of one `fn()`: the difference of two profiled
    windows of `short` and `long` calls over their difference."""
    def calls(n):
        for _ in range(n):
            fn()

    counts = [device_kernels(lambda: calls(n)) for n in (short, long)]
    return (counts[1] - counts[0]) / (long - short)


def offline_stages(agent, env, batch, learn, eval_steps, name):
    """The offline path after collection: `batch` into a replay of its size,
    `offline_learning` with `learn`'s arguments and a logger (one host copy
    a chunk), the learner's step, finite chunk means, then
    `offline_evaluation` over `eval_steps` env steps at 16 envs. B1's
    launches are counted from 0 in each of the two stages. Returns a dict:
    the bound agent, its state, the buffer and its state, the evaluation
    returns, the seconds of each stage, the logged means and B1's counts."""
    from pearl_tpu_torch.training import buffer_from_batch, offline_evaluation, offline_learning

    buffer, buf_state = buffer_from_batch(batch)
    bound = agent.for_env(env)
    obs_dim = env.observation_dim
    astate = bound.init(0, obs_dim, 1, torch.zeros(1, obs_dim, device=DEV))
    logged = []
    reset_fused_counts()
    t0 = time.perf_counter()
    astate = offline_learning(bound, astate, buffer, buf_state, seed=0,
                              logger=lambda m, i: logged.append((i, m)), **learn)
    torch.cuda.synchronize()
    t_learn = time.perf_counter() - t0
    n, every = learn["number_of_batches"], learn["log_every"]
    assert astate.learner.step == n, (name, astate.learner.step)
    assert [i for i, _ in logged] == list(range(every, n + 1, every)), logged
    assert all(math.isfinite(float(v)) for _, m in logged for v in m.values()), logged
    learn_counts = fused_counts()
    reset_fused_counts()
    t0 = time.perf_counter()
    returns = offline_evaluation(bound, astate, env, num_envs=16, max_steps=eval_steps)
    t_eval = time.perf_counter() - t0
    assert len(returns) > 0 and np.isfinite(returns).all(), name
    return {"agent": bound, "astate": astate, "buffer": buffer, "buf_state": buf_state,
            "returns": returns, "learn_s": t_learn, "eval_s": t_eval, "logged": logged,
            "b1": {"learn": learn_counts, "evaluation": fused_counts()}}


def run_offline_iql(card, behaviour, learner_state):
    """The reference's offline IQL anchor (test_convergence.py:222-263) from
    the continuous learning phase's CSAC agent, which reached Pendulum -250:
    50000 transitions collected from it at 16 envs without exploiting (seed
    7), IQL on 5000 batches of 256 (chunks of 1000, seed 0), and a greedy
    evaluation over 40000 env steps whose mean return must be above -600.
    Then the device kernels of one learn_batch, and one more chunk of
    `offline_learning` under the sync check. No kernel of the port: IQL's
    networks are PyTorch products, as the reference's are flax stacks."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import Pendulum
    from pearl_tpu_torch.policy_learners.sequential_decision_making import ImplicitQLearning
    from pearl_tpu_torch.training import collect_offline_data, offline_learning
    from pearl_tpu_torch.utils import make_generator

    env = Pendulum()
    t0 = time.perf_counter()
    batch = collect_offline_data(behaviour, env, num_transitions=50_000, num_envs=16,
                                 learner_state=learner_state, exploit=False, seed=7)
    torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    assert batch.reward.shape == (50_000,) and torch.isfinite(batch.state).all()
    out = offline_stages(PearlAgent(policy_learner=ImplicitQLearning()), env, batch,
                         dict(number_of_batches=5_000, batch_size=256, log_every=1_000), 40_000,
                         "iql")
    bound, buffer, buf_state, returns = out["agent"], out["buffer"], out["buf_state"], out["returns"]
    t_learn, t_eval, logged = out["learn_s"], out["eval_s"], out["logged"]
    mean = float(np.mean(returns))
    gen = make_generator(1, DEV)
    batches = [buffer.sample(buf_state, gen, 256) for _ in range(20)]
    box = {"astate": out["astate"], "i": 0}

    def learn_batch():
        box["astate"], _ = bound.learn_batch(box["astate"], batches[box["i"] % 20])
        box["i"] += 1

    per_learn = kernels_per_call(learn_batch)
    astate = no_sync(lambda: offline_learning(bound, box["astate"], buffer, buf_state,
                                              number_of_batches=100, batch_size=256, seed=1,
                                              log_every=100))
    last = logged[-1][1]
    print(f"offline iql anchor: {batch.reward.shape[0]} transitions collected in "
          f"{t_collect:.1f} s, {logged[-1][0]} learns of 256 in {t_learn:.1f} s ("
          + ", ".join(f"{k}={float(v):.4f}" for k, v in last.items()) + " over the last "
          f"chunk), evaluation over 40000 env steps in {t_eval:.1f} s: mean return {mean:.1f} "
          f"over {len(returns)} episodes (above -600 required); {per_learn:.1f} device kernels "
          f"per learn_batch; a chunk of 100 learns made no host sync (step "
          f"{astate.learner.step}) on {card}", flush=True)
    assert mean > -600.0, mean
    return {"mean_return": mean, "collect_s": t_collect, "learn_s": t_learn, "eval_s": t_eval,
            "kernels_per_learn_batch": per_learn}


# The offline cql phase's evaluation mean at the same setting on the CPU,
# seed 42 for the behaviour agent (python tests/torch_port_convergence.py
# --package {jax,torch} --env offline --learner offline_cql).
OFFLINE_CQL_CPU = {"jax": 470.2, "torch": 294.4}


def run_offline_cql(card, behaviour, learner_state):
    """Offline CQL through B1: 16384 greedy transitions from the learning
    phase's multi-head DQN (CartPole 500), then DQN with
    `MultiHeadQValueNetwork`, `is_conservative=True`, alpha 1 and batches of
    128 on 1000 batches, and a greedy evaluation over 16384 env steps. B1
    must launch in both, counted from 0 before each: two a learn (the
    online and the target Q), one an evaluation step. No gate on the return:
    the reference has no anchor for it; its CPU value in both packages is
    printed beside it."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.training import collect_offline_data

    env = CartPole()
    t0 = time.perf_counter()
    batch = collect_offline_data(behaviour, env, num_transitions=16_384, num_envs=16,
                                 learner_state=learner_state, exploit=True, seed=7)
    torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    assert batch.reward.shape == (16_384,) and torch.isfinite(batch.state).all()
    agent = PearlAgent(policy_learner=DeepQLearning(
        q_network=MultiHeadQValueNetwork(), is_conservative=True, conservative_alpha=1.0,
        batch_size=128))
    out = offline_stages(agent, env, batch, dict(number_of_batches=1_000, batch_size=128,
                                                 log_every=100), 16_384, "offline cql")
    b1, returns = out["b1"], out["returns"]
    assert b1["learn"]["launches"] == 2 * 1_000 == b1["learn"]["by_body"]["rows"], b1
    assert b1["evaluation"]["launches"] == 16_384 // 16 == b1["evaluation"]["by_body"]["rows"], b1
    mean = float(np.mean(returns))
    last = out["logged"][-1][1]
    print(f"offline cql: 16384 greedy transitions collected in {t_collect:.1f} s, 1000 learns "
          f"of 128 in {out['learn_s']:.1f} s (" + ", ".join(
              f"{k}={float(v):.4f}" for k, v in last.items()) + " over the last chunk), "
          f"evaluation over 16384 env steps in {out['eval_s']:.1f} s: mean return {mean:.1f} over "
          f"{len(returns)} episodes (CPU, the same setting: JAX {OFFLINE_CQL_CPU['jax']}, port "
          f"{OFFLINE_CQL_CPU['torch']}); fused_mlp launches {b1['learn']['launches']} in the "
          f"learn, {b1['evaluation']['launches']} in the evaluation, all in the rows body on "
          f"{card}", flush=True)
    return {"learn": b1["learn"], "evaluation": b1["evaluation"], "mean_return": mean}


def run_discrete_iql(card):
    """The registry's DiscreteIQL row (configs.py:380-384: one round of 256,
    a learn every 2 steps) on CartPole at 1024 envs (replay 65536 rows, the
    registry's 50000 rounded up to a multiple of 1024), through the runner
    as the history phases: a warm-up call, two timed ones (the last under
    the sync check), a profiled call and the device kernels of a step and of
    a learn; then four learns one at a time, the first under the sync check,
    each of which must move every tensor of the value net, with finite
    losses."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.policy_learners.sequential_decision_making import ImplicitQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    env = CartPole()
    agent = PearlAgent(policy_learner=ImplicitQLearning(training_rounds=1, batch_size=256),
                       replay_buffer=BasicReplayBuffer(capacity=HIST_CAPACITY))
    state, out = history_runner(agent, env, "discrete iql", card, spl=2, lpc=64)
    astate, gen = state[1], state[3]
    bound = agent.for_env(env)
    learns = 4
    for i in range(learns):
        value = astate.learner.extra.value_params
        before = [p.detach().clone() for p in value.parameters()]
        if i == 0:
            astate, metrics = no_sync(lambda: bound.learn(astate, gen))
        else:
            astate, metrics = bound.learn(astate, gen)
        moved = [not torch.equal(a, b) for a, b in zip(value.parameters(), before)]
        values = {k: v.item() for k, v in metrics.items()}
        assert moved and all(moved), moved
        assert set(values) == {"actor_loss", "critic_loss", "value_loss"}, values
        assert all(math.isfinite(v) for v in values.values()), values
    print(f"discrete iql: the value net's {len(moved)} tensors moved in each of {learns} learns "
          "(the first under the sync check); " + ", ".join(
              f"{k}={v:.6f}" for k, v in values.items()), flush=True)
    return out


# Item 19, the remaining on-device envs: the headline agent at its width on
# Acrobot and MountainCar (B1 at two more widths), the registry's rows at the
# history phases' 1024 envs, and the reference's anchors at their settings.
# One timed call a runner (three on Acrobot until PR 13).
CLASSIC_CALLS = 1
# Env steps to FrozenLake's anchor on the CPU at seed 42
# (tests/torch_port_convergence.py --env frozen_lake).
FROZEN_LAKE_CPU = {"jax": 6016, "torch": 2784}
# Catcher's gate (tests/test_ple_envs.py:175-202) is met at 4 of 16 seeds in
# JAX and 3 of 16 in the port on the CPU (tests/torch_port_convergence.py
# --env catcher). Each seed's outcome on the card repeated across machines
# (met at 42, not at the reference's 7, PR 12 and 13): the convergence
# script's default is run, and the gate must hold there.
CATCHER_SEEDS = (42,)
# The reference's recommender (tests/test_recsys.py:18-21: PRNGKey(7), 50
# items of 8, slates of 2) as numpy arrays (tests/torch_port_convergence.py's
# `export_recsys_catalog`): the script runs without JAX.
RECSYS_CATALOG = "pearl_tpu_torch/envs/data/recsys_catalog.npz"
ENV_B, ENV_SPL, ENV_LPC, ENV_CAPACITY = 1_024, 4, 16, 65_536
PLE_LPC = 32  # 128 steps a call: a Catcher fruit lands after 100


def env_runner(agent, env, num_envs, spl, lpc, seed=0):
    """`make_compiled_runner` of `agent` on `env`, initialised. Returns
    [run_fn, astate, env_states, gen, agent]."""
    from pearl_tpu_torch.training import make_compiled_runner
    from pearl_tpu_torch.utils import make_generator

    init_fn, run_fn = make_compiled_runner(agent, env, num_envs=num_envs, steps_per_learn=spl,
                                           learns_per_call=lpc)
    astate, env_states = init_fn(seed)
    return [run_fn, astate, env_states, make_generator(seed, DEV), agent]


def timed_call(runner, per_call):
    """One call of `runner`, timed to a synchronise; updates the runner's
    state in place. Returns (env-steps/s, the call's statistics)."""
    run_fn, astate, env_states, gen, _ = runner
    t0 = time.perf_counter()
    astate, env_states, stats = run_fn(astate, env_states, gen)
    torch.cuda.synchronize()
    runner[1:3] = [astate, env_states]
    return per_call / (time.perf_counter() - t0), stats


def stored(replay, field):
    return getattr(replay.storage, field)[:replay.size]


def check_envs_make_no_sync(envs, card, action=None):
    """A reset and a step of each env at ENV_B envs under the sync check:
    the vector env resets a whole batch at every step, so neither may read
    the card on the host. `action(env)` gives the step's actions, or None
    for all zeros."""
    from pearl_tpu_torch.utils import make_generator

    gen = make_generator(0, DEV)
    for env in envs:
        a = None if action is None else action(env)
        if a is None:
            a = torch.zeros((ENV_B, 1), device=DEV)
        state, obs = no_sync(lambda: env.reset(ENV_B, gen, DEV))
        _, result = no_sync(lambda: env.step(state, a))
        assert obs.shape == (ENV_B, env.observation_dim) and result.reward.shape == (ENV_B,)
    print(f"a reset and a step of {len(envs)} envs at {ENV_B} each made no host sync: "
          + ", ".join(type(e).__name__ for e in envs) + f" on {card}",
          flush=True)


def run_classic_runners(card):
    """bench.py:176-211's headline agent at its width (131072 envs, 8 steps a
    learn, 64 learns a call) on Acrobot (B1 on 6 -> 64 -> 64 -> 3) and
    MountainCar (2 -> 64 -> 64 -> 3). Acrobot: a warm-up call in which every
    action is in {0, 1, 2}, a timed call, the Q values of one act held to
    `fused_mlp_reference` to 1e-5, a profiled call and the device kernels of
    one env step and one learn. MountainCar: a warm-up and a timed call. B1
    at 512 tiled + 128 rows launches in every call of both. Then the
    registry's ContinuousSAC row (configs.py:175-178: one round of 256, a
    learn every step) on ContinuousMountainCar at 1024 envs, one short call,
    which launches no kernel of the port."""
    from pearl_tpu_torch.envs import Acrobot, ContinuousMountainCar, MountainCar
    from pearl_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        ContinuousSoftActorCritic,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    check_envs_make_no_sync([Acrobot(), MountainCar(), ContinuousMountainCar()], card)
    per_call = DRV_B * DRV_SPL * DRV_CPD
    out = {}
    for name, env, calls in (("acrobot", Acrobot(), CLASSIC_CALLS), ("mountain car",
                                                                      MountainCar(), 1)):
        runner = env_runner(headline_agent(), env, DRV_B, DRV_SPL, DRV_CPD)
        reset_fused_counts()
        rate, _ = timed_call(runner, per_call)
        warm = fused_counts()
        assert warm["by_body"] == driver_body_counts(1), (name, warm)
        index = stored(runner[1].replay, "action_index")
        assert ((index >= 0) & (index <= 2)).all() and len(index.unique()) == 3, name
        print(f"{name} runner warm-up call: {per_call / rate:.3f} s; every stored action in "
              f"{{0, 1, 2}}; B1 {warm['by_body']}", flush=True)
        # Every step is -1 until the goal (0 on Acrobot's last step).
        rates, counts = interleaved_calls({name: runner}, (name,) * calls, card, f"{name} runner",
                                          reward_bounds=(-per_call, 0))
        out[name] = {"rates": rates[name], "counts": counts[name]}
        if name != "acrobot":
            continue
        astate = runner[1]
        mlp = astate.learner.params.MLP_0
        x = astate.history_carry
        q = fused_mlp(x, *mlp.wb())
        ref = fused_mlp_reference(x, list(mlp.wb()))
        err = (q - ref).abs().max().item()
        assert q.shape == (DRV_B, 3) and err <= 1e-5, err
        run_fn, _, env_states, gen, agent = runner
        wall_s = per_call / statistics.mean(rates[name])
        prof = profile_fn(lambda: run_fn(astate, env_states, gen), wall_s, unit="acrobot call")
        per_step, per_learn, _, _, astate, env_states = kernels_per_step_and_learn(
            agent, env, astate, env_states, gen, DRV_B, step_windows=SHORT_STEPS,
            learn_windows=SHORT_LEARNS)
        out[name].update(q_max_abs_err=err, profile=prof, kernels_per_step=per_step,
                         kernels_per_learn=per_learn)
        print(f"acrobot: the Q values of one act ({DRV_B} x 3) within {err:.3e} of "
              f"fused_mlp_reference; {per_step:.1f} device kernels per env step, "
              f"{per_learn:.1f} per learn on {card}", flush=True)
    agent = dataclasses.replace(headline_agent(), policy_learner=ContinuousSoftActorCritic(
        training_rounds=1, batch_size=256), replay_buffer=BasicReplayBuffer(ENV_CAPACITY))
    runner = env_runner(agent, ContinuousMountainCar(), ENV_B, 1, ENV_LPC)
    reset_fused_counts()
    rate, stats = timed_call(runner, ENV_B * ENV_LPC)
    action = stored(runner[1].replay, "action")
    assert fused_counts()["launches"] == 0 and (action.abs() <= 1.0).all()
    assert math.isfinite(stats["reward_sum"].item())
    print(f"continuous mountain car, csac row ({ENV_B} envs, a learn every step, {ENV_LPC} "
          f"learns): {rate:.1f} env-steps/s in its first call, no B1 launch, every action in "
          f"[-1, 1] on {card}", flush=True)
    out["continuous mountain car"] = rate
    return out


def frozen_lake_greedy_return(q_table):
    """tests/test_misc_components.py:63-75: the greedy table's return from
    the start of the still lake over 20 steps, one env on the card."""
    from pearl_tpu_torch.envs import FrozenLake
    from pearl_tpu_torch.utils import make_generator

    env = FrozenLake(slippery=False)
    state, obs = env.reset(1, make_generator(0, DEV), DEV)
    total = 0.0
    for _ in range(20):
        a = q_table[obs.argmax(-1)].argmax(-1)
        state, result = env.step(state, a.to(torch.float32)[:, None])
        obs = result.observation
        total += result.reward.item()
        if result.done.item():
            break
    return total


def registry_dqn(capacity=ENV_CAPACITY, warmup_steps=20_000):
    """The registry's DQN row (configs.py:86-91: two rounds of 128, ε from
    0.5 to 0.05 over `warmup_steps`) with a replay of `capacity` rows."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    return PearlAgent(
        policy_learner=DeepQLearning(training_rounds=2, batch_size=128,
                                     exploration=EGreedyExploration(
                                         start_epsilon=0.5, end_epsilon=0.05,
                                         warmup_steps=warmup_steps)),
        replay_buffer=BasicReplayBuffer(capacity=capacity))


def run_frozen_lake(card):
    """DQN to FrozenLake's anchor (test_convergence.py:266-286: one-hot, not
    slippery, 16 envs, return 1.0 five episodes in a row within 300000
    steps), tabular Q at tests/test_misc_components.py:51-75's settings
    (lr 0.5, ε 0.3, 8 envs, 16000 steps; the greedy table reaches the goal),
    then the registry's DQN row through the runner at 1024 envs on
    OneHotObservationsFromDiscrete(FrozenLake(one_hot_obs=False)), the slip
    drawn on the card: about a third of the moves off the intended one."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import FrozenLake, FrozenLakeState, OneHotObservationsFromDiscrete
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        DeepQLearning, TabularQLearning,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    check_envs_make_no_sync([FrozenLake(), OneHotObservationsFromDiscrete(
        FrozenLake(one_hot_obs=False))], card)
    out = {}
    t0 = time.perf_counter()
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=4, batch_size=64,
                                     exploration=EGreedyExploration(epsilon=0.05)),
        replay_buffer=BasicReplayBuffer(capacity=10_000))
    res = online_learning(agent, FrozenLake(one_hot_obs=True, slippery=False), num_envs=16,
                          max_steps=300_000, learn_every_k_steps=2, learning_starts=500, seed=42,
                          target_return=1.0, target_window=5)
    seconds = time.perf_counter() - t0
    print(f"frozen lake dqn: reached_target={res.reached_target} after {res.total_steps} env "
          f"steps, {len(res.episode_returns)} episodes, {seconds:.1f} s (CPU, seed 42: "
          f"JAX {FROZEN_LAKE_CPU['jax']}, port {FROZEN_LAKE_CPU['torch']} env steps) on {card}",
          flush=True)
    assert res.reached_target, "DQN did not reach FrozenLake's 1.0 five episodes in a row"
    out["dqn"] = {"env_steps": res.total_steps, "seconds": seconds}

    t0 = time.perf_counter()
    agent = PearlAgent(
        policy_learner=TabularQLearning(learning_rate=0.5,
                                        exploration=EGreedyExploration(epsilon=0.3)),
        replay_buffer=BasicReplayBuffer(capacity=8))
    res = online_learning(agent, FrozenLake(slippery=False), num_envs=8, max_steps=8 * 2000,
                          learn_every_k_steps=1, seed=0)
    total = frozen_lake_greedy_return(res.agent_state.learner.q_table)
    seconds = time.perf_counter() - t0
    print(f"frozen lake tabular q: 16000 env steps in {seconds:.1f} s; the greedy table's "
          f"return {total} from the start on {card}", flush=True)
    assert total == 1.0, "the greedy table did not reach FrozenLake's goal"
    out["tabular q"] = {"greedy_return": total, "seconds": seconds}

    env = OneHotObservationsFromDiscrete(FrozenLake(one_hot_obs=False, slippery=True))
    runner = env_runner(registry_dqn(), env, ENV_B, ENV_SPL, ENV_LPC)
    rate, stats = timed_call(runner, ENV_B * ENV_SPL * ENV_LPC)
    replay = runner[1].replay
    obs, nxt = stored(replay, "state"), stored(replay, "next_state")
    assert (obs.sum(-1) == 1).all() and (nxt.sum(-1) == 1).all()
    assert set(stored(replay, "reward").unique().tolist()) <= {0.0, 1.0}
    assert runner[2].generator.device.type == torch.device(DEV).type  # drawn on the card
    pos = obs.argmax(-1).to(torch.int32)
    intended, _ = FrozenLake(slippery=False)._transition(
        FrozenLakeState(pos=pos, t=torch.zeros_like(pos)), stored(replay, "action"))
    on_course = (intended.pos == nxt.argmax(-1)).float().mean().item()
    # A third of the moves keep their course, and some slips into a wall or
    # the lake's edge land where the intended move would have.
    assert 0.3 < on_course < 0.6, on_course
    print(f"slippery frozen lake, one-hot wrapper, dqn row ({ENV_B} envs): {rate:.1f} env-steps/s "
          f"in its first call, {stats['episodes'].item()} episodes; {on_course:.3f} of "
          f"{replay.size} moves landed where the intended move leads on {card}", flush=True)
    out["slippery runner"] = {"rate": rate, "on_course": on_course}
    return out


def breakout_tracking_check():
    """tests/test_breakout_cnn.py:14-44 on the card: a paddle that follows
    the ball's next column for 300 steps across restarting episodes hits
    bricks (reward at least 2) and keeps the ball for at least 10 steps."""
    from pearl_tpu_torch.envs import Breakout
    from pearl_tpu_torch.utils import make_generator

    env = Breakout()
    state, _ = env.reset(1, make_generator(0, DEV), DEV)
    total, ep_len, ep_lens = 0.0, 0, []
    for i in range(300):
        ball_col, dcol = state.ball[0, 1].item(), state.ddir[0, 1].item()
        target, paddle = min(max(ball_col + dcol, 0), 9), state.paddle[0].item()
        a = 2 if target > paddle else (0 if target < paddle else 1)
        state, result = env.step(state, torch.tensor([[float(a)]], device=DEV))
        total += result.reward.item()
        ep_len += 1
        if result.terminated.item():
            ep_lens.append(ep_len)
            ep_len = 0
            state, _ = env.reset(1, make_generator(1000 + i, DEV), DEV)
    return total, max(ep_lens + [ep_len])


def run_breakout(card):
    """The registry's CNNDQN row (configs.py:256-261, 560-577: a CNN over
    (10, 10, 4), channels 16 and 32, hidden 128, one round of 512, a learn
    every 4 steps) on Breakout through the runner at 1024 envs: a warm-up
    call, a timed call, then one act and one learn under the sync check;
    then the tracking-policy dynamics check."""
    from pearl_tpu_torch.envs import Breakout
    from pearl_tpu_torch.neural_networks import CNNQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning

    env = Breakout()
    check_envs_make_no_sync([env], card)
    row = registry_dqn()
    agent = dataclasses.replace(row, policy_learner=DeepQLearning(
        q_network=CNNQValueNetwork(input_shape=(10, 10, 4), out_channels=(16, 32),
                                   kernel_sizes=(3, 3), strides=(1, 1), paddings=(1, 1),
                                   hidden_dims=(128,)),
        training_rounds=1, batch_size=512, exploration=row.policy_learner.exploration))
    runner = env_runner(agent, env, ENV_B, ENV_SPL, ENV_LPC)
    per_call = ENV_B * ENV_SPL * ENV_LPC
    rates = [timed_call(runner, per_call)[0] for _ in range(2)]
    _, astate, env_states, gen, agent = runner
    replay = astate.replay
    assert set(stored(replay, "reward").unique().tolist()) <= {0.0, 1.0}
    assert stored(replay, "state").shape[1] == 400
    bound = agent.for_env(env)
    astate, choice = no_sync(lambda: bound.act(astate, gen))
    astate, metrics = no_sync(lambda: bound.learn(astate, gen))
    loss = {k: v.item() for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in loss.values()) and choice.index.shape == (ENV_B,)
    total, longest = breakout_tracking_check()
    assert total >= 2.0 and longest >= 10, (total, longest)
    print(f"breakout, cnn dqn row ({ENV_B} envs, {ENV_SPL} steps a learn, {ENV_LPC} learns a "
          f"call): env-steps/s warm-up {rates[0]:.1f}, timed {rates[1]:.1f}; one act and one "
          f"learn made no host sync ({loss}); the tracking paddle scored {total} in 300 steps, "
          f"the longest episode {longest} steps on {card}", flush=True)
    return {"rates": rates, "tracking_reward": total, "longest_episode": longest}


def ple_envs():
    """The PLE grid of configs.py:655-711: the four games, PuckWorld and its
    PO (velocities hidden), SR (1 within 0.1 of the target) and SF (the
    risky half x > 0.5, N(0.01, 0.1) on its reward) variants; each with
    the set its rewards lie in (None: a real interval) and its horizon."""
    from pearl_tpu_torch.envs import (
        Catcher, FlappyBird, PartialObservabilityWrapper, Pixelcopter, Pong, PuckWorld,
        SafetyWrapper, SparseRewardWrapper,
    )

    def success(obs):
        return torch.linalg.vector_norm(obs[..., 0:2] - obs[..., 4:6], dim=-1) < 0.1

    games = {0.0, 1.0, -1.0, -5.0, 2.0, -4.0}  # two pipes at once, a pass and a crash
    return {
        "Catcher": (Catcher(), {0.0, 1.0, -1.0, -5.0}),
        "FlappyBird": (FlappyBird(), games),
        "Pixelcopter": (Pixelcopter(), {0.0, 1.0, -5.0, -4.0}),
        "Pong": (Pong(), {0.0, 1.0, -1.0}),
        "PuckWorld": (PuckWorld(), None),
        "PuckWorld-PO": (PartialObservabilityWrapper(PuckWorld(),
                                                     observed_indices=(0, 1, 4, 5, 6, 7)), None),
        "PuckWorld-SR": (SparseRewardWrapper(PuckWorld(), success_fn=success), {0.0, 1.0}),
        "PuckWorld-SF": (SafetyWrapper(PuckWorld(), risky_fn=lambda o, a: o[..., 0] > 0.5,
                                       noisy_reward_sigma=0.1), None),
    }


def run_ple(card):
    """The registry's DQN row at 1024 envs, one runner call on each env of
    `ple_envs` (128 steps from reset: no game reaches its 500-step horizon,
    PuckWorld never terminates), rewards in each game's set; then DQN on
    Catcher at tests/test_ple_envs.py:175-202's settings and gate."""
    from pearl_tpu_torch.envs import Catcher
    from pearl_tpu_torch.training import online_learning

    out = {}
    check_envs_make_no_sync([env for env, _ in ple_envs().values()], card)
    per_call = ENV_B * ENV_SPL * PLE_LPC
    for name, (env, rewards) in ple_envs().items():
        runner = env_runner(registry_dqn(), env, ENV_B, ENV_SPL, PLE_LPC)
        rate, stats = timed_call(runner, per_call)
        replay = runner[1].replay
        reward = stored(replay, "reward")
        assert torch.isfinite(reward).all() and not stored(replay, "truncated").any(), name
        if rewards is not None:
            assert set(reward.unique().tolist()) <= rewards, (name, reward.unique())
        if name.startswith("PuckWorld"):
            assert stats["episodes"].item() == 0 and not stored(replay, "terminated").any()
        out[name] = rate
        print(f"{name}, dqn row ({ENV_B} envs): {rate:.1f} env-steps/s in its first call, "
              f"{stats['episodes'].item()} episodes, rewards in [{reward.min().item():.4f}, "
              f"{reward.max().item():.4f}] on {card}", flush=True)
    met = []
    for seed in CATCHER_SEEDS:
        t0 = time.perf_counter()
        agent = registry_dqn(capacity=50_000, warmup_steps=30_000)
        res = online_learning(agent, Catcher(), num_envs=32, max_steps=120_000,
                              learn_every_k_steps=4, learning_starts=2_000, seed=seed)
        r = np.asarray(res.episode_returns)
        n = max(len(r) // 10, 20)
        first, last = float(r[:n].mean()), float(r[-n:].mean())
        seconds = time.perf_counter() - t0
        met.append(last > first + 1.0)
        print(f"catcher dqn, seed {seed}: the mean return of the first tenth of {len(r)} episodes "
              f"{first:.3f}, of the last {last:.3f} (gate: 1.0 higher: "
              f"{'met' if met[-1] else 'not met'}) after 120000 env steps, {seconds:.1f} s on "
              f"{card}", flush=True)
        out[f"catcher learning, seed {seed}"] = {"first": first, "last": last,
                                                 "seconds": seconds}
    assert any(met), "DQN on Catcher met the reference's gate at none of its seeds"
    return out


def recsys_click_rates(env, num_envs=4096):
    """Clicks a 20-step episode of a policy that picks at random from each
    slate and of one that picks the item of highest click probability,
    in expectation (the sum of p), over `num_envs` users on the card."""
    from pearl_tpu_torch.utils import make_generator

    gen = make_generator(1, DEV)
    rates = {}
    for policy in ("random", "oracle"):
        state, _ = env.reset(num_envs, gen, DEV)
        total = torch.zeros((), device=DEV)
        for _ in range(env.episode_length):
            p = torch.stack([env.click_probability(state.history, env.items[i].expand(
                num_envs, -1)) for i in range(env.num_items)], -1)  # (B, items)
            if policy == "random":
                score = torch.rand(p.shape, generator=gen, device=DEV)
            else:
                score = p
            pick = torch.where(state.slate_mask, score, -1.0).argmax(-1)
            total += p.gather(1, pick[:, None]).sum()
            state, _ = env.step(state, env.items[pick])
        rates[policy] = total.item() / num_envs
    return rates


# The mean-variance bandit's budget: the reference's 3000 steps of 8 envs
# cut to 1000 (every greedy act on the gated arm after 1000 on the CPU at
# seeds 0-2, in both risk modes; after 3000 on the H100, PR 12-13).
MEAN_VAR_STEPS = 1_000 * 8


def run_recsys_and_bandit(card):
    """DQN on the recommender at tests/test_recsys.py:57-80's settings (the
    identity action representation, the availability masks in replay, 32
    envs, 40000 steps, seed 3; the mean of the last 50 returns above 10.5)
    on the reference's catalog and user model (RECSYS_CATALOG), with its
    random and oracle click rates (the reference's: about 9.4 and 13.0);
    then QR-DQN on the mean-variance bandit at
    tests/test_risk_sensitive_and_transformer.py:22-59's settings (its
    24000 env steps cut to MEAN_VAR_STEPS), risk-neutral (the risky arm on
    more than 90% of 16 greedy acts) and mean-variance (the safe arm)."""
    from pearl_tpu_torch.action_representation_modules import IdentityActionRepresentation
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import FixedNumberOfStepsEnvironment, MeanVarBanditEnvironment
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        DeepQLearning, QuantileRegressionDeepQLearning,
    )
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.safety_modules import (
        QuantileNetworkMeanVarianceSafetyModule, RiskNeutralSafetyModule,
    )
    from pearl_tpu_torch.training import online_learning
    from pearl_tpu_torch.utils import make_generator
    from pearl_tpu_torch.utils.jax_params import recommender_env_from_jax

    out = {}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), RECSYS_CATALOG)
    with np.load(path) as catalog:
        env = recommender_env_from_jax(types.SimpleNamespace(**catalog), DEV)
    check_envs_make_no_sync(
        [env, MeanVarBanditEnvironment(), FixedNumberOfStepsEnvironment()], card,
        action=lambda e: e.items[:1].expand(ENV_B, -1) if e is env else None)
    baselines = recsys_click_rates(env)
    t0 = time.perf_counter()
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=2, batch_size=128,
            exploration=EGreedyExploration(start_epsilon=0.3, end_epsilon=0.05,
                                           warmup_steps=10_000),
            action_representation=IdentityActionRepresentation()),
        replay_buffer=BasicReplayBuffer(capacity=20_000),
        track_available_masks=True)
    res = online_learning(agent, env, num_envs=32, max_steps=40_000, learn_every_k_steps=4,
                          learning_starts=1_000, seed=3)
    last = float(np.asarray(res.episode_returns)[-50:].mean())
    replay = res.agent_state.replay
    chosen = stored(replay, "curr_available_mask").gather(
        1, stored(replay, "action_index").long()[:, None])
    seconds = time.perf_counter() - t0
    print(f"recsys dqn: the mean of the last 50 returns {last:.2f} (gate 10.5; this catalog's "
          f"random slate pick {baselines['random']:.2f}, oracle {baselines['oracle']:.2f}) "
          f"after 40000 env steps, {seconds:.1f} s; every stored action was in its slate on "
          f"{card}", flush=True)
    assert chosen.all() and last > 10.5, last
    out["recsys"] = {"mean_last_50": last, **baselines, "seconds": seconds}

    for name, module, arm in (("risk-neutral", RiskNeutralSafetyModule(), 1),
                              ("mean-variance", QuantileNetworkMeanVarianceSafetyModule(
                                  variance_weighting_coefficient=0.5), 0)):
        t0 = time.perf_counter()
        agent = PearlAgent(
            policy_learner=QuantileRegressionDeepQLearning(
                training_rounds=2, batch_size=64, exploration=EGreedyExploration(epsilon=0.3),
                discount_factor=0.0),
            replay_buffer=BasicReplayBuffer(capacity=2048), safety_module=module)
        bandit = MeanVarBanditEnvironment()
        res = online_learning(agent, bandit, num_envs=8, max_steps=MEAN_VAR_STEPS,
                              learn_every_k_steps=2, learning_starts=256, seed=0)
        learner = agent.for_env(bandit).policy_learner
        _, choice = learner.act(res.agent_state.learner, torch.zeros((16, 1), device=DEV), None,
                                make_generator(0, DEV), exploit=True)
        share = (choice.index == arm).float().mean().item()
        seconds = time.perf_counter() - t0
        print(f"mean-variance bandit, qr-dqn {name}: arm {arm} on {share:.3f} of 16 greedy acts "
              f"(gate 0.9) after {MEAN_VAR_STEPS} env steps, {seconds:.1f} s on {card}",
              flush=True)
        assert share > 0.9, (name, share)
        out[name] = {"share": share, "seconds": seconds}
    return out


# Item 18, the contextual bandits: the reference's anchors
# (tests/test_bandits.py), its UCI CB protocol (benchmarks/cb.py:66-253) and
# the registry's LinUCB row (configs.py:822) at the runner's width.
# final_avg_regret of JAX on the CPU at seed 0 (letter, T = 5000, 10 envs);
# a uniform policy's is 25/26 = 0.962. The gate is loose: seeds 0-2 spread
# over 0.18-0.58.
CB_JAX_CPU = {"NeuralSquareCB": 0.264, "NeuralFastCB": 0.184, "NeuralLinUCB": 0.283,
              "NeuralLinTS": 0.348}
CB_GATE, CB_T, CB_ENVS = 0.75, 5_000, 10
LINUCB_B, LINUCB_LPC, LINUCB_CALLS = 131_072, 16, 3


def bandit_online(learner, env, steps, num_envs=16):
    """`online_learning` of `learner` on `env` with a buffer sized to the
    envs and a learn every step (tests/test_bandits.py:94-103). Returns the
    learner bound to the env and the final learner state."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online_learning

    agent = PearlAgent(policy_learner=learner, replay_buffer=BasicReplayBuffer(capacity=num_envs))
    res = online_learning(agent, env, num_envs=num_envs, max_steps=steps, learn_every_k_steps=1,
                          seed=0)
    return agent.for_env(env).policy_learner, res.agent_state.learner


def check_bandit_steps_make_no_sync(card):
    """One act, env step, observe and learn each of LinUCB (the synthetic
    env, 16 envs), the CB benchmark's NeuralLinUCB and the disjoint linear
    container (26 arms of 17 x 17 statistics, one batched factor), both on
    letter at 10 envs, under the sync check, after one step outside it."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.benchmarks.cb import cb_benchmark_method
    from pearl_tpu_torch.benchmarks.cb_datasets import get_dataset
    from pearl_tpu_torch.envs import (
        ClassificationBanditEnvironment, LinearSyntheticBanditEnvironment, VectorEnv,
    )
    from pearl_tpu_torch.policy_learners.contextual_bandits import (
        DisjointLinearBandit, LinearBandit,
    )
    from pearl_tpu_torch.policy_learners.exploration_modules import UCBExploration
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.utils import make_generator

    X, y, _ = get_dataset("letter")
    letter = ClassificationBanditEnvironment(features=X, labels=y)
    cases = [
        ("linucb", PearlAgent(policy_learner=LinearBandit(exploration=UCBExploration(alpha=1.0)),
                              replay_buffer=BasicReplayBuffer(16)),
         LinearSyntheticBanditEnvironment(seed=3), 16),
        ("neural linucb", cb_benchmark_method("NeuralLinUCB", X.shape[1], 26, CB_T), letter,
         CB_ENVS),
        ("disjoint linear", PearlAgent(policy_learner=DisjointLinearBandit(
            exploration=UCBExploration(alpha=1.0)), replay_buffer=BasicReplayBuffer(CB_ENVS)),
         letter, CB_ENVS),
    ]
    for name, agent, env, n in cases:
        agent = agent.for_env(env)
        venv = VectorEnv(env, n, torch.device(DEV))
        gen = make_generator(0, DEV)
        env_states, obs = venv.reset(gen)
        astate = agent.init(0, venv.observation_dim, n, obs, device=DEV)

        def step(astate, env_states):
            astate, choice = agent.act(astate, gen)
            env_states, result, next_obs = venv.step(env_states, choice.action, gen)
            astate = agent.observe(astate, result, next_obs, gen)
            astate, _ = agent.learn(astate, gen)
            return astate, env_states

        astate, env_states = step(astate, env_states)
        no_sync(lambda: step(astate, env_states))
        if name == "disjoint linear":
            assert astate.learner.models.A.shape == (26, 17, 17)
    print("an act, an env step, an observe and a learn of " + ", ".join(c[0] for c in cases)
          + f" made no host sync on {card}", flush=True)


def run_bandit_anchors(card):
    """The reference's bandit tests on the card: LinUCB on the synthetic env
    (seed 3, 16 envs, 4096 steps: greedy regret on 256 contexts below 0.1,
    tests/test_bandits.py:108-122); UCB(alpha=40) disjoint arms on the
    ten-times MAB (2048 steps: arm 3 greedily everywhere, :132-147); disjoint
    linear arms on 4096 ground-truth rows (W to atol 0.02, :177-198); the
    neural-linear sigmoid head in both placements (loss below 0.01 after 300
    batches, :389-424); then the sync checks."""
    from pearl_tpu_torch.api.spaces import DiscreteActionSpace
    from pearl_tpu_torch.envs import (
        LinearSyntheticBanditEnvironment, RewardIsTenTimesActionMABEnvironment,
    )
    from pearl_tpu_torch.neural_networks.contextual_bandit import LinearRegression
    from pearl_tpu_torch.policy_learners.contextual_bandits import (
        DisjointBanditContainer, LinearBandit, NeuralLinearBandit,
    )
    from pearl_tpu_torch.policy_learners.exploration_modules import UCBExploration
    from pearl_tpu_torch.replay_buffers import TransitionBatch
    from pearl_tpu_torch.utils import make_generator

    out = {}
    t0 = time.perf_counter()
    env = LinearSyntheticBanditEnvironment(seed=3)
    learner, lstate = bandit_online(LinearBandit(exploration=UCBExploration(alpha=1.0)), env,
                                    4096)
    gen = make_generator(42, DEV)
    ctx = torch.rand((256, 4), generator=gen, device=DEV) * 2 - 1
    _, choice = learner.act(lstate, ctx, None, gen, exploit=True)
    means = env._mean_rewards(ctx)
    regret = (means.max(1).values - means.gather(1, choice.index.long()[:, None])[:, 0]).mean()
    out["linucb_regret"] = regret = regret.item()
    out["linucb_s"] = time.perf_counter() - t0
    assert regret < 0.1, regret
    print(f"linucb anchor: greedy regret {regret:.6f} on 256 contexts (gate 0.1) after 4096 "
          f"env steps at 16 envs, {out['linucb_s']:.1f} s on {card}", flush=True)

    t0 = time.perf_counter()
    mab = RewardIsTenTimesActionMABEnvironment(num_arms=4)
    learner, lstate = bandit_online(DisjointBanditContainer(exploration=UCBExploration(
        alpha=40.0)), mab, 2048)
    _, choice = learner.act(lstate, torch.zeros((8, 1), device=DEV), None, gen, exploit=True)
    picks = choice.index.tolist()
    out["mab_s"] = time.perf_counter() - t0
    assert picks == [3] * 8, picks
    print(f"ten-times mab: the disjoint UCB arms pick {picks} greedily after 2048 env steps, "
          f"{out['mab_s']:.1f} s on {card}", flush=True)

    rng = np.random.RandomState(0)
    n, arms, feat = 4096, 3, 4
    W = rng.uniform(-1, 1, (arms, feat)).astype(np.float32)
    states = rng.uniform(-1, 1, (n, feat)).astype(np.float32)
    idx = rng.randint(0, arms, (n,)).astype(np.int32)
    reward = np.einsum("nf,nf->n", states, W[idx]).astype(np.float32)

    def put(x):
        return torch.from_numpy(x).to(DEV)

    batch = TransitionBatch(
        state=put(states), action=put(idx[:, None].astype(np.float32)), reward=put(reward),
        next_state=put(states), terminated=torch.ones(n, dtype=torch.bool, device=DEV),
        truncated=torch.zeros(n, dtype=torch.bool, device=DEV), action_index=put(idx))
    space = DiscreteActionSpace.discrete(arms)
    container = DisjointBanditContainer(exploration=UCBExploration(alpha=0.0),
                                        l2_reg_lambda=1e-4).bind(space)
    cstate = container.init(None, feat, space, 8, DEV)
    cstate, _ = container.learn_batch(cstate, batch)
    coefs = LinearRegression(feature_dim=feat).coefs(cstate.models)[:, 1:].cpu().numpy()
    out["disjoint_w_err"] = err = float(np.abs(coefs - W).max())
    assert err <= 0.02, err
    print(f"disjoint linear arms: W recovered to {err:.3e} (gate 0.02) from {n} rows on {card}",
          flush=True)

    w = torch.tensor([1.5, -2.0, 0.8, 0.0], device=DEV)
    space = DiscreteActionSpace.create(torch.eye(2))
    losses = {}
    t0 = time.perf_counter()
    for separate in (False, True):
        nlb = NeuralLinearBandit(
            exploration=UCBExploration(alpha=0.1), output_activation="sigmoid",
            separate_uncertainty=separate, hidden_dims=(32,), linear_feature_dim=8,
            learning_rate=3e-3, state_features_only=True).bind(space)
        nstate = nlb.init(torch.Generator().manual_seed(0), 4, space, 1, DEV)
        g = make_generator(3, DEV)
        for _ in range(300):
            x = torch.randn((64, 4), generator=g, device=DEV)
            nbatch = TransitionBatch(
                state=x, action=torch.zeros((64, 1), device=DEV), reward=torch.sigmoid(x @ w),
                next_state=x, terminated=torch.ones(64, dtype=torch.bool, device=DEV),
                truncated=torch.zeros(64, dtype=torch.bool, device=DEV),
                action_index=torch.zeros(64, dtype=torch.int32, device=DEV))
            nstate, metrics = nlb.learn_batch(nstate, nbatch)
        losses["separate" if separate else "joint"] = metrics["loss"].item()
    out["sigmoid_head_loss"] = losses
    out["sigmoid_head_s"] = time.perf_counter() - t0
    assert max(losses.values()) < 0.01, losses
    print(f"neural-linear sigmoid head: loss after 300 batches joint {losses['joint']:.6f}, "
          f"separate {losses['separate']:.6f} (gate 0.01), {out['sigmoid_head_s']:.1f} s on "
          f"{card}", flush=True)
    check_bandit_steps_make_no_sync(card)
    return out


def run_cb_benchmark(card):
    """The reference's UCI CB protocol on its widest dataset: every CB method
    on letter (20000 rows, 16 features, 26 classes: 5-bit actions, hidden
    (64, 16), SquareCB gamma 10 sqrt(T * 21)), T = 5000 over 10 envs at seed
    0, each method's final_avg_regret below CB_GATE beside JAX's on the CPU,
    with its interactions/s and the device kernels of one act and one learn
    of its agent; then the reference test's yeast cell (NeuralSquareCB,
    T = 1500, below 0.5; test_cb_benchmark.py:47-56) and the offline
    protocol on satimage (below 0.4, :60-64)."""
    from pearl_tpu_torch.benchmarks.cb import (
        CB_METHODS, cb_benchmark_method, run_cb_benchmark_suite, run_offline_cb_experiment,
    )
    from pearl_tpu_torch.benchmarks.cb_datasets import get_dataset
    from pearl_tpu_torch.envs import ClassificationBanditEnvironment, VectorEnv
    from pearl_tpu_torch.utils import make_generator

    out = {}
    X, y, _ = get_dataset("letter")
    letter = ClassificationBanditEnvironment(features=X, labels=y)
    for method in CB_METHODS:
        t0 = time.perf_counter()
        res = run_cb_benchmark_suite(datasets=("letter",), methods=(method,), T=CB_T,
                                     num_envs=CB_ENVS, seed=0)
        seconds = time.perf_counter() - t0
        regret = res["letter"][method]["final_avg_regret"]
        # The device kernels of one act and of one learn, after 32 steps.
        agent = cb_benchmark_method(method, X.shape[1], 26, CB_T).for_env(letter)
        venv = VectorEnv(letter, CB_ENVS, torch.device(DEV))
        gen = make_generator(0, DEV)
        env_states, obs = venv.reset(gen)
        astate = agent.init(0, venv.observation_dim, CB_ENVS, obs, device=DEV)
        for _ in range(32):
            astate, choice = agent.act(astate, gen)
            env_states, result, next_obs = venv.step(env_states, choice.action, gen)
            astate = agent.observe(astate, result, next_obs, gen)
        per_act = kernels_per_call(lambda: agent.act(astate, gen))
        per_learn = kernels_per_call(lambda: agent.learn(astate, gen))
        out[method] = {"final_avg_regret": regret, "seconds": seconds,
                       "interactions_per_s": CB_T / seconds, "kernels_per_act": per_act,
                       "kernels_per_learn": per_learn}
        print(f"cb letter {method}: final_avg_regret {regret:.4f} (gate {CB_GATE}; JAX on the "
              f"CPU at seed 0 {CB_JAX_CPU[method]}; uniform 0.962), {CB_T} interactions in "
              f"{seconds:.1f} s = {CB_T / seconds:.1f} interactions/s, {per_act:.1f} device "
              f"kernels per act, {per_learn:.1f} per learn on {card}", flush=True)
        assert regret < CB_GATE, (method, regret)
    t0 = time.perf_counter()
    res = run_cb_benchmark_suite(datasets=("yeast",), methods=("NeuralSquareCB",), T=1500,
                                 num_envs=CB_ENVS)
    yeast = res["yeast"]["NeuralSquareCB"]["final_avg_regret"]
    seconds = time.perf_counter() - t0
    print(f"cb yeast NeuralSquareCB (T = 1500): final_avg_regret {yeast:.4f} (gate 0.5), "
          f"{seconds:.1f} s on {card}", flush=True)
    assert yeast < 0.5, yeast
    t0 = time.perf_counter()
    offline = run_offline_cb_experiment("satimage", T=4000, train_batches=400,
                                        num_eval_steps=100)["final_avg_regret"]
    seconds_offline = time.perf_counter() - t0
    print(f"cb offline satimage (4000 logged, 400 batches, 100 greedy steps): final_avg_regret "
          f"{offline:.4f} (gate 0.4), {seconds_offline:.1f} s on {card}", flush=True)
    assert offline < 0.4, offline
    out.update(yeast=yeast, offline_satimage=offline)
    return out


def run_linucb_runner(card):
    """The registry's LinUCB row (configs.py:822: UCB alpha 1) on the
    synthetic env through `make_compiled_runner` at 131072 envs, with the
    buffer sized to the envs and a learn at every step
    (linear_bandit.py:111-121), 16 learns a call: a warm-up call, timed
    calls, one under the sync check, a profiled call (the idle share) and
    the device kernels of one env step and of one learn. The mean regret of
    the last call must fall below the first's."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import LinearSyntheticBanditEnvironment
    from pearl_tpu_torch.policy_learners.contextual_bandits import LinearBandit
    from pearl_tpu_torch.policy_learners.exploration_modules import UCBExploration
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    env = LinearSyntheticBanditEnvironment()
    agent = PearlAgent(policy_learner=LinearBandit(exploration=UCBExploration(alpha=1.0)),
                       replay_buffer=BasicReplayBuffer(capacity=LINUCB_B))
    runner = env_runner(agent, env, LINUCB_B, 1, LINUCB_LPC)
    per_call = LINUCB_B * LINUCB_LPC
    warm, stats = timed_call(runner, per_call)
    regrets = [stats["regret_sum"].item() / per_call]
    print(f"linucb runner warm-up call: {per_call / warm:.3f} s, mean regret {regrets[0]:.6f}",
          flush=True)
    rates = []
    for _ in range(LINUCB_CALLS):
        rate, stats = timed_call(runner, per_call)
        rates.append(rate)
        regrets.append(stats["regret_sum"].item() / per_call)
    run_fn, astate, env_states, gen, _ = runner
    astate, env_states, stats = no_sync(lambda: run_fn(astate, env_states, gen))
    regrets.append(stats["regret_sum"].item() / per_call)
    assert astate.replay.size == 0 and math.isfinite(regrets[-1])
    wall_s = per_call / statistics.mean(rates)
    prof = profile_fn(lambda: run_fn(astate, env_states, gen), wall_s, unit="linucb call")
    per_step, per_learn, _, _, astate, env_states = kernels_per_step_and_learn(
        agent, env, astate, env_states, gen, LINUCB_B, step_windows=SHORT_STEPS,
        learn_windows=SHORT_LEARNS)
    print(f"linucb runner ({LINUCB_B} envs, a learn every step, {LINUCB_LPC} learns a call): "
          f"warm-up {warm:.1f}, then env-steps/s " + ", ".join(f"{r:.1f}" for r in rates)
          + f"; mean regret a call, first to last (the last under the sync check) "
          + ", ".join(f"{r:.6f}" for r in regrets) + f"; {per_step:.1f} device kernels per env "
          f"step, {per_learn:.1f} per learn on {card}", flush=True)
    assert regrets[-1] < regrets[0], regrets
    return {"rates": rates, "warm_up": warm, "regrets": regrets, "profile": prof,
            "kernels_per_step": per_step, "kernels_per_learn": per_learn}


# Population (phase 39): the members of tests/test_population.py, then the
# headline agent of bench.py:176-211 as four members at its width.
POP_M = 4
POP_TIMED = 2  # timed population dispatches


def population_test_agent():
    """tests/test_population.py:16-27's DQN."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer

    return PearlAgent(
        policy_learner=DeepQLearning(
            training_rounds=1, batch_size=64,
            exploration=EGreedyExploration(start_epsilon=0.5, end_epsilon=0.05,
                                           warmup_steps=4_000),
        ),
        replay_buffer=BasicReplayBuffer(capacity=8_192),
    )


def timed_population(dispatches, seed, members=POP_M):
    """`population_learning` with the headline agent at its width for
    `dispatches` dispatches (0: the members' fresh states), an unreachable
    target (the stop check live), timed with the host clock to a
    synchronise, set-up included."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import population_learning

    t0 = time.perf_counter()
    pop = population_learning(
        headline_agent(), CartPole(), num_members=members, num_envs=DRV_B,
        max_steps=DRV_B * DRV_SPL * DRV_CPD * dispatches, learn_every_k_steps=DRV_SPL,
        chunks_per_dispatch=DRV_CPD, seed=seed, target_return=1e9,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert pop.total_steps == DRV_B * DRV_SPL * DRV_CPD * dispatches and not pop.reached_target
    if dispatches:
        assert pop.return_curves.shape == (DRV_CPD * dispatches, members)
        assert np.isfinite(pop.return_curves).all() and (pop.total_episodes > 0).all()
    return pop, wall


def population_dispatcher(agent, pop):
    """One more dispatch of a population, continuing from its states: every
    member's chunks in turn and the stack of their summary rows, as
    `population_learning` runs them, without its host fetch. Returns
    dispatch() -> the (M, C, 6) rows, left on the card."""
    members = [driver_dispatcher(agent, pop.agent_states[m], pop.env_states[m], "summary",
                                 seed=100 + m)
               for m in range(pop.num_members)]
    return lambda: torch.stack([member() for member in members])


def run_population(card):
    """Phase 39. (1) Member equals solo on the card: 2 members at
    tests/test_population.py:30-50's settings against solo
    `online_learning(stats="summary")` runs at their seeds, the learner's
    parameters held to rtol 2e-4 / atol 2e-5 (the reference test's
    tolerance), the whole state's exact agreement printed. (2) The headline
    agent as 4 members at bench.py's DQN width (131072 envs each, batch
    1024, replay 2097152, 8 steps a learn, 64 chunks a dispatch): a warm-up
    dispatch from fresh members, under the sync check (the host fetch
    excluded) and profiled (the idle share, against the timed dispatches'
    wall); then the solo summary driver, 2 timed population dispatches and
    the solo driver again, one dispatch each; B1's launches by body per
    member and dispatch. Its learning check runs in phase 11's child process
    (`start_ppo_learning`), after PPO's anchor."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import online_learning, population_learning
    from pearl_tpu_torch.utils import compare

    out = {}
    t0 = time.perf_counter()
    small = dict(num_envs=8, max_steps=2_048, learn_every_k_steps=8, learning_starts=256)
    pop = population_learning(population_test_agent(), CartPole(), num_members=2, seeds=[7, 11],
                              **small)
    exact = []
    for i, s in enumerate([7, 11]):
        solo = online_learning(population_test_agent(), CartPole(), seed=s, stats="summary",
                               **small)
        for a, b in zip(pop.member_state(i).learner.params.parameters(),
                        solo.agent_state.learner.params.parameters()):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        exact.append(compare(pop.member_state(i), solo.agent_state, rtol=0, atol=0) == "")
        np.testing.assert_allclose(pop.return_curves[:, i], solo.return_curve, rtol=2e-4,
                                   atol=2e-5)
    print(f"population, member equals solo (seeds 7 and 11, 8 envs, 2048 steps): learner "
          f"parameters within rtol 2e-4 / atol 2e-5 of the solo runs, whole states bit-equal "
          f"{exact}, {time.perf_counter() - t0:.1f} s on {card}", flush=True)

    agent = headline_agent()
    # The warm-up dispatch, from fresh members: under the sync check (the
    # host fetch excluded) and profiled; its idle share is taken against the
    # timed dispatches' wall.
    fresh, setup = timed_population(0, seed=0)
    dispatch = population_dispatcher(agent, fresh)
    box = {}
    t0 = time.perf_counter()
    events = device_events(lambda: box.update(rows=no_sync(dispatch)))
    warm = time.perf_counter() - t0
    assert box["rows"].shape == (POP_M, DRV_CPD, 6) and torch.isfinite(box["rows"]).all()
    print(f"population ({POP_M} members x {DRV_B} envs): set-up {setup:.3f} s, a warm-up "
          f"dispatch {warm:.3f} s (profiled, under the sync check): no host sync on {card}",
          flush=True)
    solo_rates, pop_rates = [], []
    per_dispatch = DRV_B * DRV_SPL * DRV_CPD
    res, wall = timed_driver(agent, 1, seed=1, stats="summary")
    solo_rates.append(per_dispatch / wall)
    reset_fused_counts()
    pop, wall = timed_population(POP_TIMED, seed=10)
    counts = fused_counts()
    want = {k: POP_M * v for k, v in driver_body_counts(POP_TIMED).items()}
    assert counts["by_body"] == want, (counts, want)
    pop_rates.append(POP_M * per_dispatch * POP_TIMED / wall)
    pop_wall = wall / POP_TIMED
    res, wall = timed_driver(agent, 1, seed=2, stats="summary")
    solo_rates.append(per_dispatch / wall)
    print(f"population ({POP_M} members x {DRV_B} envs, {DRV_CPD} chunks of {DRV_SPL} steps a "
          f"dispatch), env-steps/s in the order run (set-up included): solo driver "
          f"{solo_rates[0]:.1f}, population {pop_rates[0]:.1f} in all = "
          f"{pop_rates[0] / POP_M:.1f} a member over {POP_TIMED} dispatches ({pop_wall:.3f} s a "
          f"dispatch), solo driver {solo_rates[1]:.1f}; recent returns "
          f"{np.round(pop.recent_returns, 3).tolist()}; B1 {counts['launches']} launches, by "
          f"body {counts['by_body']} ({driver_body_counts(1)} a member and dispatch) on {card}",
          flush=True)
    prof = profile_fn(None, pop_wall, unit="population dispatch", events=events)
    out.update(counts=counts, solo_rates=solo_rates, pop_rates=pop_rates, profile=prof)
    return out


def _population_learning_file():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "build", "chip_smoke_population.pt")


def run_population_learning(card):
    """Phase 39's learning check, tests/test_population.py:53-75 (4 members,
    16 envs, 40000 steps each): every member's recent return above its early
    curve. The population is saved for phase 41's round trip."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.training import population_learning
    from pearl_tpu_torch.utils.checkpoint import save

    t0 = time.perf_counter()
    learn = population_learning(population_test_agent(), CartPole(), num_members=4,
                                num_envs=16, max_steps=40_000, learn_every_k_steps=4,
                                learning_starts=1_000, seed=3)
    early = learn.return_curves[: max(len(learn.return_curves) // 10, 1)].mean(axis=0)
    print(f"population learning (4 members x 16 envs, 40000 steps each, seed 3): early "
          f"{np.round(early, 2).tolist()}, recent {np.round(learn.recent_returns, 2).tolist()}, "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    assert (learn.recent_returns > early).all(), (early, learn.recent_returns)
    assert learn.recent_returns.mean() > 2.0 * early.mean()
    save(_population_learning_file(), learn)


def host_syncs(fn):
    """The host syncs `fn()` makes, counted by torch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def run_host_loops(card):
    """Phase 40. (1) The headline multi-head DQN through
    `agent_online_learning_host` on the port's CartPole, a batch of one:
    steps/s, host syncs per step (two runs of different lengths, so that
    set-up cancels) and B1 at B = 1 in every act (the rows body). (2) The
    Atari agent of examples_torch/atari_dqn.py, built by its `make_agent()`,
    on SyntheticAtari at 84x84x4, one env: the (32, 64, 64) CNN, batch 32,
    a bfloat16 replay of 100000 rows, a learn every 4 steps after 64 (the
    example's 10000 cut to fit the phase). gymnasium is not on the card's
    machine: the adapter and the Atari wrappers are held on the CPU only."""
    from examples_torch.atari_dqn import make_agent as make_atari_agent
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole, SyntheticAtari
    from pearl_tpu_torch.neural_networks import MultiHeadQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import agent_online_learning_host

    out = {}

    def dqn():
        return PearlAgent(
            policy_learner=DeepQLearning(q_network=MultiHeadQValueNetwork(), training_rounds=1,
                                         batch_size=128),
            replay_buffer=BasicReplayBuffer(capacity=10_000),
        )

    def loop(agent, env, steps, learning_starts):
        return agent_online_learning_host(agent, env, max_steps=steps, learn_every_k_steps=4,
                                          learning_starts=learning_starts, seed=0)

    steps, starts = 1_000, 100
    learns = (steps - starts) // 4
    loop(dqn(), CartPole(), 50, 0)  # warm-up
    reset_fused_counts()
    t0 = time.perf_counter()
    returns = loop(dqn(), CartPole(), steps, starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused_counts()
    assert counts["by_body"] == {"rows": steps + 2 * learns, "tiled": 0, "general": 0}, counts
    assert returns and all(r >= 1.0 for r in returns)
    syncs = [host_syncs(lambda n=n: loop(dqn(), CartPole(), n, starts)) for n in (200, 600)]
    per_step = (syncs[1] - syncs[0]) / 400
    print(f"host loop, multi-head dqn on CartPole (1 env, {steps} steps, a learn every 4 after "
          f"{starts}): {steps / wall:.1f} steps/s, {len(returns)} episodes, {per_step:.3f} host "
          f"syncs per step ({syncs[0]} in 200 steps, {syncs[1]} in 600, set-up included); B1 "
          f"{counts['launches']} launches by body {counts['by_body']} ({steps} acts at B = 1, "
          f"{learns} learns) on {card}", flush=True)
    out["counts"] = counts

    atari = make_atari_agent()
    torch.cuda.reset_peak_memory_stats()
    steps, starts = 400, 64
    t0 = time.perf_counter()
    returns = loop(atari, SyntheticAtari(), steps, starts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = host_syncs(lambda: loop(atari, SyntheticAtari(), 100, starts))
    assert returns and all(math.isfinite(r) for r in returns)
    print(f"host loop, atari topology (SyntheticAtari 84x84x4, 1 env, CNN (32, 64, 64) / (8, 4, "
          f"3) / (4, 2, 1) / 512, batch 32, bf16 replay of 100000 rows, {steps} steps, a learn "
          f"every 4 after {starts}): {steps / wall:.1f} steps/s set-up included, {len(returns)} "
          f"episodes, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {syncs} "
          f"host syncs in a 100-step run on {card}", flush=True)
    return out


def roundtrip(state, directory, name):
    """`save` and `restore` of a state: the restored state equals it, and
    every restored generator draws what the saved one draws next."""
    from pearl_tpu_torch.utils import compare
    from pearl_tpu_torch.utils.checkpoint import restore, save
    from pearl_tpu_torch.utils.pytree import walk_leaves

    path = os.path.join(directory, name)
    save(path, state)
    back = restore(path, state)
    diff = compare(back, state)
    assert diff == "", (name, diff)
    gens = [(a, b) for (_, a), (_, b) in zip(walk_leaves(state), walk_leaves(back))
            if isinstance(a, torch.Generator)]
    for a, b in gens:
        assert a.device == b.device and a.device.type == "cuda" and a is not b, name
        draw_a = torch.rand(4, generator=a, device=a.device)
        draw_b = torch.rand(4, generator=b, device=b.device)
        assert torch.equal(draw_a, draw_b), name
    return back, len(gens), [str(a.device) for a, _ in gens]


def run_registry_and_checkpoint(card, population):
    """Phase 41. Every METHODS row built, trained a short call at 4 envs on
    its env family (tests/test_all_methods_matrix.py:52-92: 3 learns, on-policy
    rollouts cut to 16 steps) and round-tripped through `save`/`restore`,
    CUDA generators included; the learning population's states round-tripped
    the same way; and a conv1-cache visual agent restored whole, its cache
    equal to a refresh from the restored weights. Counts the launches of B1,
    B2, B3, B6b and B7 over the rows."""
    import tempfile

    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.benchmarks import METHODS
    from pearl_tpu_torch.benchmarks.guarantees import env_for_method
    from pearl_tpu_torch.envs import SyntheticAtari, VectorEnv
    from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
    from pearl_tpu_torch.neural_networks import CNNQValueNetwork
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import OnPolicyReplayBuffer, VisualReplayBuffer
    from pearl_tpu_torch.training import online_learning
    from pearl_tpu_torch.utils import make_generator

    wrappers = visual_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    reset_fused_counts()
    n_envs = 4
    gens = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        for name, method in sorted(METHODS.items()):
            agent = method.make_agent(n_envs)
            env = env_for_method(method, agent)
            rollout = method.on_policy_rollout
            if rollout is not None:
                rollout = 16
                agent = dataclasses.replace(agent, replay_buffer=OnPolicyReplayBuffer(
                    capacity=rollout * n_envs, num_envs=n_envs))
            learn_every = rollout if rollout is not None else 8
            res = online_learning(agent, env, num_envs=n_envs,
                                  max_steps=learn_every * n_envs * 3,
                                  learn_every_k_steps=learn_every,
                                  learning_starts=0 if rollout is not None else 32, seed=0)
            assert res.agent_state.learner.step > 0, name
            _, n, devices = roundtrip(res.agent_state, directory, name)
            gens.append((name, n, devices))
        rows_s = time.perf_counter() - t0
        counts = {"fused_mlp": fused_counts()}
        counts.update({name: fn.launches for name, fn in wrappers.items()})
        assert counts["fused_mlp"]["launches"] > 0, counts
        for name in ("ring_write", "ring_write_where", "copy_fence", "masked_scale_fence4"):
            assert counts[name] > 0, (name, counts)
        with_gens = [(n, k, d) for n, k, d in gens if k]
        assert with_gens, gens
        print(f"registry: {len(METHODS)} rows trained at {n_envs} envs and round-tripped in "
              f"{rows_s:.1f} s, CUDA generators continued their streams in "
              f"{len(with_gens)} rows ({sum(k for _, k, _ in with_gens)} generators); launches "
              f"over the rows: B1 {counts['fused_mlp']}, B2 {counts['ring_write']}, B7 "
              f"{counts['ring_write_where']}, B3 {counts['copy_fence']}, B6b "
              f"{counts['masked_scale_fence4']} on {card}", flush=True)

        roundtrip(population.agent_states, directory, "population")
        print(f"registry: the learning population's {population.num_members} member states "
              f"round-tripped on {card}", flush=True)

        T, B = 4, 8
        net = CNNQValueNetwork(input_shape=(12, 12, T), kernel_sizes=(4, 2), strides=(2, 1),
                               hidden_dims=(32,), time_major_stack=True, conv1_cache=True)
        agent = PearlAgent(
            policy_learner=DeepQLearning(q_network=net, training_rounds=1, batch_size=16,
                                         history_summarizer=FrameRingHistorySummarization(T)),
            replay_buffer=VisualReplayBuffer(capacity=8 * B, stack=T, num_envs=B,
                                             dedup_next=True),
        )
        env = SyntheticAtari(height=12, width=12, frames=1, episode_len=5)
        res = online_learning(agent, env, num_envs=B, max_steps=16 * B, learn_every_k_steps=4,
                              learning_starts=2 * B, seed=0)
        bound, venv = agent.for_env(env), VectorEnv(env, B, torch.device("cuda"))
        astate, env_states, gen = res.agent_state, res.env_states, make_generator(0, "cuda")
        for _ in range(2):  # cache writes after the last learn's refresh
            astate, choice = bound.act(astate, gen)
            env_states, result, next_obs = venv.step(env_states, choice.action, gen)
            astate = bound.observe(astate, result, next_obs, gen)
        back, _, _ = roundtrip(astate, directory, "conv1_cache")
        carry = back.history_carry
        fresh = net.refresh_cache(back.learner.params, dataclasses.replace(carry, cache=None))
        err = (carry.cache.float() - fresh.float()).abs().max().item()
        torch.testing.assert_close(carry.cache, fresh, rtol=2e-4, atol=2e-4)
        print(f"checkpoint: a conv1_cache visual agent restored whole; its cache against a "
              f"refresh from the restored weights: max abs diff {err:.3e} (held to 2e-4) on "
              f"{card}", flush=True)
    return counts


# Phase 47: pearl_tpu_torch/EXTENDING.md, whose two code blocks are the
# example learner and its registry row.
EXTENDING_DOC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pearl_tpu_torch",
                             "EXTENDING.md")


def extending_example():
    """The `Method` row of EXTENDING.md's `ClippedRewardDQN`, built from the
    document's code blocks as written (the learner block as a module, the
    row block as an entry of `configs`' METHODS dict)."""
    import re

    from pearl_tpu_torch.benchmarks import configs

    with open(EXTENDING_DOC) as f:
        learner_block, row_block = re.findall(r"```python\n(.*?)```", f.read(), re.S)
    scope = {}
    exec(learner_block, scope)
    scope = {**vars(configs), "ClippedRewardDQN": scope["ClippedRewardDQN"]}
    exec("rows = {\n" + row_block + "}", scope)
    (row,) = scope["rows"].values()
    return row


def run_learning_signal(card):
    """Phase 47. Every METHODS row through the frozen-target check on
    cuda:0 (tests/test_learning_signal_matrix.py: 32 steps a env of rollouts
    at 4 envs, 16 for on-policy rows, the targets frozen, 60 learns, 90 for
    visual rows), one line a row: the loss must start above 1e-3, fall under
    0.15 of its start (0.30 for CNNDQN and CQL), and a |TD| end under 0.5.
    Then the TD fixed points (tests/test_td_discount_calibration.py: DQN,
    Double DQN and deep SARSA at gamma 0.9 within 0.5 of 10 after 800
    learns, DQN at 0.45 within 0.5 of 1.82 and more than 5 from 10), then
    EXTENDING.md's example row. B1 counted over the MultiHeadDQN row's acts
    and learns, B2, B7, B3 and B6b over the VisualDQN row's. Every miss is
    listed, then fails the phase."""
    from pearl_tpu_torch.benchmarks import METHODS
    from pearl_tpu_torch.benchmarks.guarantees import fixed_point_q, frozen_target_signal
    from pearl_tpu_torch.policy_learners.sequential_decision_making import (
        DeepQLearning, DeepSARSA, DoubleDQN,
    )

    wrappers = visual_wrappers()
    rows = dict(sorted(METHODS.items()))
    example = extending_example()
    rows[example.name] = example
    misses, counts, seconds = [], {}, {}
    t0 = time.perf_counter()
    for name, method in rows.items():
        reset_fused_counts()
        for fn in wrappers.values():
            fn.launches = 0
        t = time.perf_counter()
        report = frozen_target_signal(name, method, device="cuda")
        seconds[name] = time.perf_counter() - t
        if name == "MultiHeadDQN":
            counts["fused_mlp"] = fused_counts()
        if name == "VisualDQN":
            counts.update({k: fn.launches for k, fn in wrappers.items()})
        failures = report.failures()
        misses += [f"{name}: {f}" for f in failures]
        print(f"learning signal: {name}: {report.metric} early {report.early:.6f} late "
              f"{report.late:.6f} ratio {report.ratio:.6f} threshold {report.threshold} over "
              f"{report.learns} learns in {seconds[name]:.2f} s: "
              f"{'met' if not failures else 'MISSED'} on {card}", flush=True)
    rows_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for label, cls, gamma in (("DQN", DeepQLearning, 0.9), ("Double DQN", DoubleDQN, 0.9),
                              ("deep SARSA", DeepSARSA, 0.9), ("DQN control", DeepQLearning, 0.45)):
        q = fixed_point_q(cls, gamma, device="cuda")
        target = 1.0 / (1.0 - gamma)
        met = abs(q - target) < 0.5 and (gamma == 0.9 or abs(q - 10.0) > 5.0)
        if not met:
            misses.append(f"fixed point {label} at gamma {gamma}: Q {q} against {target}")
        print(f"td fixed point: {label} at gamma {gamma}: Q(s0, a0) {q:.6f} against "
              f"1 / (1 - gamma) = {target:.6f} after 800 learns: {'met' if met else 'MISSED'} "
              f"on {card}", flush=True)
    fixed_s = time.perf_counter() - t0

    b1 = counts["fused_mlp"]
    # 32 acts at 4 envs, then 60 learns of 2 rounds, each the online and the
    # target Q: every one a rows-body launch.
    assert b1 == {"launches": 32 + 60 * 2 * 2,
                  "by_body": {"rows": 32 + 60 * 2 * 2, "tiled": 0, "general": 0}}, b1
    for name in ("ring_write", "ring_write_where", "copy_fence", "masked_scale_fence4"):
        assert counts[name] > 0, (name, counts)
    assert counts["masked_scale_fence4"] > 32, counts  # the learns' windows too
    print(f"learning signal: {len(rows) - 1} METHODS rows and the EXTENDING.md row in "
          f"{rows_s:.1f} s (slowest {max(seconds, key=seconds.get)} "
          f"{max(seconds.values()):.2f} s), the fixed points in {fixed_s:.1f} s; launches: "
          f"B1 {b1} over the MultiHeadDQN row, B2 {counts['ring_write']}, B7 "
          f"{counts['ring_write_where']}, B3 {counts['copy_fence']}, B6b "
          f"{counts['masked_scale_fence4']} over the VisualDQN row; misses {len(misses)} on "
          f"{card}", flush=True)
    assert not misses, misses
    return counts


# ------------------------------------------------------------ distribution
# Phases 42-45 (item 20). The card's machine has one H100: the mesh of one
# (NCCL) is the path each rank takes when every rank has a GPU of its own;
# two ranks share cuda:0 over gloo (NCCL refuses two ranks on one device),
# which checks the collectives at full width but is no scaling number: two
# processes share one card, and gloo stages CUDA tensors through the host.
DP_RANKS = 2
DP_DEVICE = "cuda:0"
DP_TIMED = 2  # timed dispatches of the two-rank driver
DP_RUNNER_STEPS = 4  # timed DataParallelRunner steps (a learn each)
DP_LEARNS = 8  # learns timed alone on each rank
ENSEMBLE_STEPS = 3
# What each rank runs: this script imported from its own directory.
DP_RANK_COMMAND = "import chip_smoke as c; c.dp_rank({role!r}, {rank}, {url!r})"
# test_convergence.py:289-316, the mesh anchor: 16 envs over 2 ranks.
MESH_ANCHOR = dict(num_envs=16, max_steps=250_000, learn_every_k_steps=2, learning_starts=500,
                   seed=42, target_return=500.0, target_window=20)


def run_dp_world1(card, driver):
    """Phase 42: `online_learning(mesh=make_mesh(1))` (NCCL, a world of one
    in this process) with the headline agent at its width (131072 envs,
    summary stats, 64 chunks a dispatch), one dispatch with its set-up,
    against phase 13's warm-up run of the solo driver at the same seed
    (seed 0; run just before): the whole states (replay and envs
    included), the return curve and the counts bit-equal, B1 at 512 tiled +
    128 rows; then one more mesh dispatch timed alone and one under the
    sync check (the host fetch excluded) and profiled (the idle share
    against the dispatch timed alone). The mesh closes the world of one it
    made."""
    from pearl_tpu_torch.parallel import make_mesh
    from pearl_tpu_torch.utils import compare

    with make_mesh(1, device=DP_DEVICE) as mesh:  # closed, with its world, at the end
        assert mesh.backend == ("nccl" if mesh.device.type == "cuda" else "gloo"), mesh
        agent = headline_agent()
        solo, solo_wall = driver["warm_up"], driver["warm_up_wall"]
        reset_fused_counts()
        dp, dp_wall = timed_driver(agent, 1, seed=0, stats="summary", mesh=mesh)
        counts = fused_counts()
        assert counts["by_body"] == driver_body_counts(1), counts
        for name, a, b in (("agent state", dp.agent_state, solo.agent_state),
                           ("env states", dp.env_states, solo.env_states)):
            diff = compare(a, b, rtol=0, atol=0)
            assert diff == "", f"mesh of one against the solo driver, {name}: {diff}"
        assert np.array_equal(dp.return_curve, solo.return_curve), "return curves differ"
        assert (dp.total_episodes, dp.mean_return) == (solo.total_episodes, solo.mean_return)
        dispatch = driver_dispatcher(agent, dp.agent_state, dp.env_states, "summary", seed=8,
                                     mesh=mesh)
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        alone = time.perf_counter() - t0
        box = {}
        events = device_events(lambda: box.update(rows=no_sync(dispatch)))
        assert box["rows"].shape == (DRV_CPD, 6) and torch.isfinite(box["rows"]).all()
        prof = profile_fn(None, alone, unit="mesh dispatch", events=events)
        per = DRV_B * DRV_SPL * DRV_CPD
        print(f"dp world-1 ({mesh.backend}): bit-equal to the solo driver at seed 0 (whole "
              f"states, return curve, {dp.total_episodes} episodes); env-steps/s with set-up (the mesh's the "
              f"communicator's too): solo {per / solo_wall:.1f}, mesh of one {per / dp_wall:.1f}; "
              f"one mesh dispatch {alone:.3f} s alone ({per / alone:.1f} env-steps/s, "
              f"{alone / driver['dispatch_s']:.3f}x phase 13's solo dispatch alone, "
              f"{driver['dispatch_s']:.3f} s), one under the sync check and profiled: no host "
              f"sync; B1 "
              f"{counts['launches']} launches, by body {counts['by_body']} on {card}", flush=True)
    return {"counts": counts, "sps": per / dp_wall, "solo_sps": per / solo_wall,
            "dispatch_s": alone, "profile": prof}


def _dp_dir(role):
    """A directory of the checkout's ignored build tree for one pair of ranks."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(here, "build", "chip_smoke_dp", role)
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    return directory


def start_dp_ranks(role):
    """Two child processes, the ranks of `dp_rank(role, ...)`, joined by a
    rendezvous file; their output goes to files beside it."""
    directory = _dp_dir(role)
    url = f"file://{directory}/rendezvous"
    here = os.path.dirname(os.path.abspath(__file__))
    children = []
    for r in range(DP_RANKS):
        log = open(os.path.join(directory, f"rank{r}.log"), "w")
        children.append((subprocess.Popen(
            [sys.executable, "-c", DP_RANK_COMMAND.format(role=role, rank=r, url=url)],
            cwd=here, stdout=log, stderr=subprocess.STDOUT, text=True,
        ), log))
    return {"role": role, "directory": directory, "children": children}


def finish_dp_ranks(ranks, timeout_s=900):
    """Wait for both ranks, print their output, and return each rank's
    result. A rank that fails ends the other (it would wait in its next
    collective) and fails the phase."""
    deadline = time.monotonic() + timeout_s
    children = [child for child, _ in ranks["children"]]
    try:
        while any(c.poll() is None for c in children):
            failed = [c for c in children if c.poll() not in (None, 0)]
            assert not failed and time.monotonic() < deadline, (
                f"{ranks['role']} ranks: exit codes {[c.poll() for c in children]}")
            time.sleep(0.2)
    finally:
        for child, log in ranks["children"]:
            if child.poll() is None:
                child.kill()
                child.wait()
            log.close()
        for r in range(DP_RANKS):
            with open(os.path.join(ranks["directory"], f"rank{r}.log")) as f:
                print(f.read().rstrip(), flush=True)
    results = []
    for r, child in enumerate(children):
        assert child.returncode == 0, f"{ranks['role']} rank {r} failed ({child.returncode})"
        with open(os.path.join(ranks["directory"], f"rank{r}.log")) as f:
            line = [x for x in f.read().splitlines() if x.startswith("DP_RESULT ")][-1]
        results.append(json.loads(line[len("DP_RESULT "):]))
    return results


def dp_rank(role, rank, url):
    """One rank of a pair on cuda:0 over gloo: "drive" runs phases 43 and 45,
    "anchor" phase 44. Loads the kernels phase 2 built (a rank builds
    nothing) and prints one line `DP_RESULT {json}`."""
    import torch.distributed as dist

    from pearl_tpu_torch.ops import _build
    from pearl_tpu_torch.parallel import multihost

    missing = [n for n in ("fused_mlp",) if not _build.library_path(n).exists()]
    assert not missing, f"phase 2's build of {missing} is missing: a rank builds nothing"
    multihost.initialize(url, DP_RANKS, rank, backend="gloo")
    card = card_line()
    result = {"drive": dp_drive, "anchor": dp_anchor}[role](rank, card)
    print("DP_RESULT " + json.dumps(result), flush=True)
    dist.destroy_process_group()


def _env_digest(env_states):
    from pearl_tpu_torch.utils.pytree import named_leaves

    return sum(float(v.double().abs().sum()) for _, v in named_leaves(env_states)
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def plain_fold_summary_rows(own):
    """The plain version of the summary fold over the ranks: (ranks, C, 6)
    rows of each rank -> (C, 6), the sums added and the recent return the
    mean of the ranks' weighted by their finished envs."""
    own = np.asarray(own, dtype=np.float64)
    weight = own[..., 5]
    rows = own.sum(axis=0)
    rows[:, 2] = (own[..., 2] * weight).sum(axis=0) / np.maximum(weight.sum(axis=0), 1.0)
    return rows


def dp_drive(rank, card):
    """Phase 43 on one rank (65536 of the 131072 envs): `online_learning`
    with `check_replication`, a warm-up dispatch and DP_TIMED timed ones,
    the replicas checked after each, each dispatch's statistics kept before
    and after their fold over the ranks; B1's launches by body; then
    `DataParallelRunner` and learns timed alone. Phase 45 after it."""
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import DataParallelRunner, make_mesh
    from pearl_tpu_torch.training import online as online_mod
    from pearl_tpu_torch.training import online_learning

    mesh = make_mesh(DP_RANKS, device=DP_DEVICE, backend="gloo")
    axis = mesh.axis("data")
    agent = headline_agent()
    per = DRV_B * DRV_SPL * DRV_CPD
    kw = dict(num_envs=DRV_B, learn_every_k_steps=DRV_SPL, chunks_per_dispatch=DRV_CPD,
              target_return=1e9, target_window=20, stats="summary", mesh=mesh,
              check_replication=True)
    t0 = time.perf_counter()
    online_learning(agent, CartPole(), max_steps=per, seed=0, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    folds, fold = [], online_mod._fold_stats

    def recorded(stats_dev, stats, axis):
        folded = fold(stats_dev, stats, axis)
        folds.append((stats_dev.clone(), folded.clone()))
        return folded

    online_mod._fold_stats = recorded
    reset_fused_counts()
    t0 = time.perf_counter()
    res = online_learning(agent, CartPole(), max_steps=per * DP_TIMED, seed=1, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused_counts()
    online_mod._fold_stats = fold
    assert counts["by_body"] == driver_body_counts(DP_TIMED), counts
    # check_replication checked the first timed dispatch; this, the last.
    online_mod._assert_replicated(res.agent_state, axis)
    assert res.total_episodes > 0 and np.isfinite(res.return_curve).all()
    print(f"dp rank {rank} (gloo on {DP_DEVICE}, {DRV_B // DP_RANKS} envs): warm-up dispatch "
          f"{warm:.3f} s with set-up; {DP_TIMED} timed dispatches {wall:.3f} s, replicas "
          f"bit-identical after each; B1 {counts['by_body']} on {card}", flush=True)

    runner = DataParallelRunner(agent, CartPole(), mesh, num_envs_per_device=DRV_B // DP_RANKS,
                                steps_per_learn=DRV_SPL)
    astate, env_states = runner.init(3)
    astate, env_states, reward = runner.step(astate, env_states)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rewards = []
    for _ in range(DP_RUNNER_STEPS):
        astate, env_states, reward = runner.step(astate, env_states)
        rewards.append(reward)
    torch.cuda.synchronize()
    runner_s = (time.perf_counter() - t0) / DP_RUNNER_STEPS
    online_mod._assert_replicated(astate, axis)
    t0 = time.perf_counter()
    for _ in range(DP_LEARNS):
        astate, _ = runner.agent.learn(astate, runner.generator)
    torch.cuda.synchronize()
    learn_s = (time.perf_counter() - t0) / DP_LEARNS
    online_mod._assert_replicated(astate, axis)
    out = {
        "rank": rank, "warm_s": warm, "wall_s": wall, "counts": counts,
        "steps": res.total_steps, "curve": res.return_curve.tolist(),
        "episodes": res.total_episodes, "mean_return": res.mean_return,
        "env_digest": _env_digest(res.env_states), "runner_step_s": runner_s,
        "runner_rewards": [float(r) for r in rewards],
        "runner_env_steps_per_call": runner.env_steps_per_call, "learn_s": learn_s,
        "folds": [(own.tolist(), folded.tolist()) for own, folded in folds],
    }
    out["ensemble"] = dp_ensemble(rank, card)
    return out


def dp_ensemble(rank, card):
    """Phase 45 on one rank of a (1, 2) mesh: the registry's BootstrappedDQN
    (K = 10, batch 128) with members [5 j, 5 j + 5) on model rank j, the
    sharded learn against the unsharded learn of all ten members on the
    same batches, within rtol 1e-5 / atol 1e-6."""
    import copy

    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import (
        make_2d_mesh,
        make_ensemble_sharded_learn_batch,
        split_ensemble_state,
    )
    from pearl_tpu_torch.policy_learners.sequential_decision_making import BootstrappedDQN
    from pearl_tpu_torch.replay_buffers import TransitionBatch
    from pearl_tpu_torch.utils import compare

    dev = torch.device(DP_DEVICE)
    mesh = make_2d_mesh(1, DP_RANKS, device=DP_DEVICE, backend="gloo")
    agent = PearlAgent(policy_learner=BootstrappedDQN(training_rounds=2, batch_size=128))
    agent = agent.for_env(CartPole())
    learner = agent.policy_learner
    K, B = learner.q_network.ensemble_size, learner.batch_size
    full = learner.init(torch.Generator().manual_seed(0), 4, learner.action_space, 1, dev)
    j = mesh.axis("model").rank
    piece = split_ensemble_state(learner, full, DP_RANKS)[j]
    learn = make_ensemble_sharded_learn_batch(agent, mesh)
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    worst = 0.0
    for _ in range(ENSEMBLE_STEPS):
        index = torch.randint(0, 2, (B,), generator=gen, device=dev, dtype=torch.int32)
        batch = TransitionBatch(
            state=torch.randn((B, 4), generator=gen, device=dev),
            action=index[:, None].float(), reward=torch.randn((B,), generator=gen, device=dev),
            next_state=torch.randn((B, 4), generator=gen, device=dev),
            terminated=torch.rand((B,), generator=gen, device=dev) < 0.1,
            truncated=torch.zeros((B,), dtype=torch.bool, device=dev), action_index=index,
            bootstrap_mask=(torch.rand((B, K), generator=gen, device=dev) < 0.5).float(),
        )
        full, want = learner.learn_batch(full, batch)
        piece, got = learn(piece, batch)
        for k in ("loss", "per_sample_td"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
            worst = max(worst, float((got[k] - want[k]).abs().max()))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mine = split_ensemble_state(learner, copy.deepcopy(full), DP_RANKS)[j]
    diff = compare(piece, mine, rtol=1e-5, atol=1e-6)
    assert diff == "", f"sharded against unsharded, model rank {j}: {diff}"
    for p, q in zip(piece.params.parameters(), mine.params.parameters()):
        worst = max(worst, float((p - q).detach().abs().max()))
    print(f"ensemble rank {rank} (model rank {j} of a (1, {DP_RANKS}) mesh, members "
          f"[{j * K // DP_RANKS}, {(j + 1) * K // DP_RANKS}) of {K}): {ENSEMBLE_STEPS} sharded "
          f"learns equal the unsharded learn within rtol 1e-5 / atol 1e-6 (max abs diff "
          f"{worst:.3e}), {seconds:.3f} s on {card}", flush=True)
    return {"model_rank": j, "max_abs_diff": worst, "seconds": seconds}


def dp_anchor(rank, card):
    """Phase 44 on one rank: the mesh anchor, DQN with the default
    Q-network to CartPole 500 on 16 envs over the two ranks; replicas
    byte for byte equal at the end (spread 0)."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import CartPole
    from pearl_tpu_torch.parallel import make_mesh
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
    from pearl_tpu_torch.training import online as online_mod
    from pearl_tpu_torch.training import online_learning

    mesh = make_mesh(DP_RANKS, device=DP_DEVICE, backend="gloo")
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=4, batch_size=128,
                                     exploration=EGreedyExploration(epsilon=0.05)),
        replay_buffer=BasicReplayBuffer(capacity=10_000),
    )
    t0 = time.perf_counter()
    res = online_learning(agent, CartPole(), mesh=mesh, **MESH_ANCHOR)
    seconds = time.perf_counter() - t0
    online_mod._assert_replicated(res.agent_state, mesh.axis("data"))
    last = float(np.mean(res.episode_returns[-20:])) if len(res.episode_returns) else 0.0
    print(f"mesh anchor rank {rank}: reached_target={res.reached_target} after "
          f"{res.total_steps} env steps, {len(res.episode_returns)} episodes, last-20 mean "
          f"return {last:.1f}, {seconds:.1f} s; replicas byte for byte equal (spread 0) on "
          f"{card}", flush=True)
    assert res.reached_target, "the mesh anchor did not reach CartPole 500"
    return {"rank": rank, "steps": res.total_steps, "seconds": seconds,
            "episodes": len(res.episode_returns), "last_mean": last}


def run_dp_ranks(card):
    """Phases 43 and 45: the two ranks of `dp_drive` on cuda:0, held against
    each other: the folded statistics identical and equal to the plain fold
    of the ranks' own rows, each env shard its own, B1 at 512 tiled + 128
    rows a rank and dispatch, the runner's rewards the same on both ranks;
    the rates labelled a correctness run."""
    results = finish_dp_ranks(start_dp_ranks("drive"))
    a, b = results
    for key in ("steps", "curve", "episodes", "mean_return", "runner_rewards"):
        assert a[key] == b[key], (key, a[key], b[key])
    assert len(a["folds"]) == len(b["folds"]) == DP_TIMED, len(a["folds"])
    for (own_a, folded_a), (own_b, folded_b) in zip(a["folds"], b["folds"]):
        plain = plain_fold_summary_rows([own_a, own_b]).tolist()
        assert folded_a == folded_b == plain, "the summary fold is not the plain fold"
    assert a["env_digest"] != b["env_digest"], "the ranks' env shards are the same"
    per_rank = DRV_B // DP_RANKS * DRV_SPL * DRV_CPD * DP_TIMED
    walls = [r["wall_s"] for r in results]
    total = DP_RANKS * per_rank / max(walls)
    runner = a["runner_env_steps_per_call"] / max(r["runner_step_s"] for r in results)
    print(f"dp, two ranks sharing {DP_DEVICE} over gloo (a correctness run, not a scaling "
          f"number: two processes share one card and gloo stages CUDA tensors through the "
          f"host): {total:.1f} env-steps/s in all, "
          f"{[round(per_rank / w, 1) for w in walls]} a rank over {DP_TIMED} dispatches; "
          f"the runner {runner:.1f} env-steps/s in all; host time a learn (its gloo "
          f"all-reduce included) {[round(1e3 * r['learn_s'], 3) for r in results]} ms; "
          f"folded statistics identical on both ranks and equal to the plain fold of their "
          f"own rows ({a['episodes']} episodes, mean return "
          f"{a['mean_return']:.3f}); env shards differ; B1 by body a rank "
          f"{[r['counts']['by_body'] for r in results]} on {card}", flush=True)
    worst = max(r["ensemble"]["max_abs_diff"] for r in results)
    print(f"ensemble parallelism: sharded equals unsharded on both model ranks (max abs diff "
          f"{worst:.3e}) on {card}", flush=True)
    return {"counts": [r["counts"] for r in results], "sps": total, "runner_sps": runner,
            "learn_ms": [1e3 * r["learn_s"] for r in results]}


def finish_dp_anchor(ranks, card):
    results = finish_dp_ranks(ranks)
    assert results[0]["steps"] == results[1]["steps"]
    print(f"mesh anchor: CartPole 500 after {results[0]['steps']} env steps over "
          f"{DP_RANKS} ranks on {card}", flush=True)
    return results[0]


EXAMPLES = ("dqn_cartpole", "multi_chip_dqn", "dp_scaling", "sac_pendulum", "frozen_lake_dqn",
            "rc_safety_pendulum", "population_sweep", "recommender_system",
            "contextual_bandit_linucb", "cb_benchmark")
# What each script prints at its end.
EXAMPLE_LINES = {
    "dqn_cartpole": "last-20 mean return=", "multi_chip_dqn": "replica_spread=0.0",
    "dp_scaling": " OK ", "sac_pendulum": "last-20 mean return=",
    "frozen_lake_dqn": "success rate first", "rc_safety_pendulum": "constraint=0.05: return",
    "population_sweep": "best member: seed", "recommender_system": "BootstrappedDQN+LSTM:",
    "contextual_bandit_linucb": "NeuralLinUCB   cumulative regret",
    "cb_benchmark": "offline yeast",
}
# Vector steps a driver call (past Pendulum's 200-step episode), the last 16 learning.
EX_CHUNKS, EX_LEARNING = 224, 16
EX_BANDIT_STEPS, EX_CB_T, EX_DP_CALLS = 64, 100, 2


def state_devices(tree):
    """The device types of the tensors and module parameters and buffers of
    a state (optimizers and generators left out: AdamW keeps its step count
    on the host)."""
    from torch import nn

    out = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.add(x.device.type)
        elif isinstance(x, nn.Module):
            out.update(t.device.type for t in list(x.parameters()) + list(x.buffers()))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


class _Tee:
    """Standard output copied into a buffer."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _budget(driver, kw):
    """The keyword arguments of a driver call at phase 46's budget:
    EX_CHUNKS vector steps a call on the script's own envs, learning in the
    last EX_LEARNING."""
    if driver in ("online_learning", "population_learning"):
        n = kw["num_envs"]
        return dict(max_steps=EX_CHUNKS * n, learning_starts=(EX_CHUNKS - EX_LEARNING) * n)
    if driver == "run_bandit_benchmark":
        return dict(steps=EX_BANDIT_STEPS)
    if driver == "run_offline_cb_experiment":
        return dict(T=500, train_batches=50, num_eval_steps=20)
    return {}


def _cut(driver, orig, states, cut=True):
    """`orig` at phase 46's budget (with `cut`), the learner state it
    returns kept in `states`."""
    def fn(*args, **kw):
        if cut:
            kw.update(_budget(driver, kw))
        out = orig(*args, **kw)
        if driver == "online_learning":
            states.append(out.agent_state.learner)
        elif driver == "population_learning":
            states.extend(a.learner for a in out.agent_states)
        elif driver == "run_bandit_benchmark":
            states.append(out["agent_state"].learner)
        return out
    return fn


def run_examples(card):
    """Phase 46: each script of examples_torch/ through its `main(device=
    "cuda:0")` at a cut budget (its drivers wrapped, as the reference's
    smoke test wraps them: EX_CHUNKS vector steps a call on the script's own
    envs, learning in the last EX_LEARNING; the bandits EX_BANDIT_STEPS
    steps; the CB suite at T = EX_CB_T with the offline protocol at T = 500,
    50 train batches and 20 evaluation steps; dp_scaling at EX_DP_CALLS
    timed calls through its own arguments, so that its in-process width and
    its child ranks run the same budget). Each must print its line and
    leave its learner state on the card. multi_chip_dqn runs on an NCCL mesh of one, closed at its end, and
    a second world of one works after it; dp_scaling runs width 1 on NCCL,
    then widths 1 and 2 on gloo, the two ranks sharing cuda:0 (a correctness
    run: its rates are no scaling number), every replica equal byte for
    byte. atari_dqn's main needs gymnasium and the ROMs: phase 40 builds its
    agent. No example reaches B1 (their Q-networks are VanillaQValueNetwork
    and the ensemble)."""
    import contextlib
    import importlib

    import torch.distributed as dist

    from pearl_tpu_torch.benchmarks import cb
    from pearl_tpu_torch.parallel import make_mesh

    importlib.import_module("examples_torch.atari_dqn")  # imports without gymnasium
    on = torch.device(DP_DEVICE).type
    reset_fused_counts()
    seconds = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        states, patched = [], []
        # The CB suite's own calls keep the suite's T; the wrap only keeps
        # their states.
        for target, driver, cut in ((mod, "online_learning", True),
                                    (mod, "population_learning", True),
                                    (mod, "run_bandit_benchmark", True),
                                    (mod, "run_offline_cb_experiment", True),
                                    (cb, "run_bandit_benchmark", False)):
            if hasattr(target, driver) and name != "dp_scaling":
                patched.append((target, driver, getattr(target, driver)))
                setattr(target, driver, _cut(driver, getattr(target, driver), states, cut))
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                if name == "dp_scaling":
                    rows = mod.main(device=DP_DEVICE, calls=EX_DP_CALLS)
                    rows += mod.main(device=DP_DEVICE, ranks=2, backend="gloo",
                                     calls=EX_DP_CALLS)
                elif name == "cb_benchmark":
                    mod.main(device=DP_DEVICE, t=EX_CB_T)
                else:
                    out = mod.main(device=DP_DEVICE)
        finally:
            for target, driver, orig in patched:
                setattr(target, driver, orig)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        printed = "".join(tee.text)
        assert EXAMPLE_LINES[name] in printed, f"{name} did not print its line"
        assert not dist.is_initialized(), f"{name} left a process group open"
        if name == "dp_scaling":
            assert [r["devices"] for r in rows] == [1, 1, 2], rows
            assert all(r["spread"] == 0.0 for r in rows), rows
            continue
        if name == "multi_chip_dqn":
            assert out[1] == 0.0, out[1]
            with make_mesh(1, device=DP_DEVICE) as again:  # a second world of one
                assert again.backend == ("nccl" if on == "cuda" else "gloo")
                assert dist.is_initialized()
            assert not dist.is_initialized()
        assert states, f"{name}: no learner state"
        for state in states:
            assert state_devices(state) == {on}, (name, state_devices(state))
    counts = fused_counts()
    assert counts["launches"] == 0, counts
    print(f"examples on {DP_DEVICE}: every script printed its line, its learner states on "
          f"{on}, no process group left; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; B1 launches {counts['launches']} on {card}", flush=True)
    return seconds


def print_kernel_resources(build_dir):
    """Registers and spills of the redesigned kernels, as ptxas reported them
    at this build (the build keeps its output beside each library)."""
    import re

    wanted = ("fused_mlp_tiled_kernel", "fused_mlp_rows_kernel", "fused_mlp_general_kernel",
              "ring_conv1_mma_kernel", "synthetic_frames_kernel")
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

    sources = ["fused_mlp", "ring_write", "layout_fence", "conv_cache", "ring_conv",
               "synthetic_frames"]
    for name, path in _build.build_all(sources).items():
        print(f"built {name}: {path}", flush=True)
    print_kernel_resources(_build.BUILD_DIR)
    phase("build", t0)

    t0 = time.perf_counter()
    max_err, timing = check_fused_mlp(card)
    visual_timing = check_visual_kernels(card)
    visual_timing.update(check_act_kernels(card))
    check_env_kernel(card)
    phase("kernels", t0)

    t0 = time.perf_counter()
    launches, fused_by_body = run_runner(card)
    phase("runner", t0)

    t0 = time.perf_counter()
    visual_launches, sps_default = run_visual_runner(card, frames=1, calls=2)
    multichannel, _ = run_visual_runner(card, frames=VIS_C, calls=2)
    assert multichannel["masked_scale_fence4"] == 0 == visual_launches["masked_scale_fence"]
    visual_launches["masked_scale_fence"] = multichannel["masked_scale_fence"]
    phase("visual runner", t0)

    t0 = time.perf_counter()
    cached, sps_cached = run_visual_runner(card, frames=1, calls=2, conv1_cache=True)
    fused, sps_fused = run_visual_runner(card, frames=1, calls=2, ring_conv=True)
    # The fence path once more, so that the other paths stand between two
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

    # PPO's learning anchor runs in a process of its own beside four other
    # learning anchors (host-bound runs that report no rate), and is waited
    # for before the next phase that measures one.
    t0 = time.perf_counter()
    ppo_learning = start_ppo_learning()
    mesh_anchor = start_dp_ranks("anchor")
    try:
        dqn_behaviour = run_learning(card)
        phase("learning (ppo learning beside it)", t0)

        t0 = time.perf_counter()
        csac_behaviour = run_continuous_learning(card)
        phase("continuous learning (ppo learning beside it)", t0)

        t0 = time.perf_counter()
        run_offline_iql(card, *csac_behaviour)
        phase("offline iql anchor (ppo learning beside it)", t0)

        t0 = time.perf_counter()
        run_her_learning(card)
        phase("her learning (ppo learning beside it)", t0)

        t0 = time.perf_counter()
        learning_population = finish_ppo_learning(ppo_learning)
        phase("ppo and population learning, the rest of their run", t0)

        t0 = time.perf_counter()
        finish_dp_anchor(mesh_anchor, card)
        phase("mesh anchor, the rest of its run", t0)

    finally:
        for child in [ppo_learning] + [c for c, _ in mesh_anchor["children"]]:
            if child.poll() is None:
                child.kill()
                child.wait()

    t0 = time.perf_counter()
    run_ppo_runner(card)
    phase("ppo runner", t0)

    t0 = time.perf_counter()
    run_discrete_actor_critic(card)
    phase("discrete actor-critic", t0)

    t0 = time.perf_counter()
    driver = run_driver(card)
    phase("driver", t0)

    t0 = time.perf_counter()
    dp_world1 = run_dp_world1(card, driver)
    phase("dp world-1", t0)

    t0 = time.perf_counter()
    dp_ranks = run_dp_ranks(card)
    phase("dp two ranks and ensemble", t0)

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

    t0 = time.perf_counter()
    packed = run_packed_runner(card)
    phase("packed runner", t0)

    t0 = time.perf_counter()
    prioritized = run_prioritized_runner(card)
    phase("prioritized runner", t0)

    t0 = time.perf_counter()
    run_bootstrapped(card)
    phase("bootstrapped dqn", t0)

    t0 = time.perf_counter()
    run_two_tower_and_tabular(card)
    phase("two-tower dqn and tabular q", t0)

    t0 = time.perf_counter()
    run_stacking_visual(card)
    phase("stacking visual runner", t0)

    t0 = time.perf_counter()
    run_lstm_dqn(card)
    phase("lstm dqn", t0)

    t0 = time.perf_counter()
    run_transformer_dqn(card)
    phase("transformer dqn", t0)

    t0 = time.perf_counter()
    run_lstm_actor_critic(card)
    phase("lstm actor-critic", t0)

    t0 = time.perf_counter()
    run_rc(card)
    phase("rc", t0)

    t0 = time.perf_counter()
    masked = run_masked_headline(card, packed["profiles"]["basic"])
    phase("masked headline runner", t0)

    t0 = time.perf_counter()
    offline_cql = run_offline_cql(card, *dqn_behaviour)
    phase("offline cql", t0)

    t0 = time.perf_counter()
    run_discrete_iql(card)
    phase("discrete iql", t0)

    t0 = time.perf_counter()
    classic = run_classic_runners(card)
    phase("classic runners", t0)

    t0 = time.perf_counter()
    run_frozen_lake(card)
    phase("frozen lake", t0)

    t0 = time.perf_counter()
    run_breakout(card)
    phase("breakout", t0)

    t0 = time.perf_counter()
    run_ple(card)
    phase("ple and puckworld", t0)

    t0 = time.perf_counter()
    run_recsys_and_bandit(card)
    phase("recommender and bandit", t0)

    t0 = time.perf_counter()
    run_bandit_anchors(card)
    phase("bandit anchors", t0)

    t0 = time.perf_counter()
    run_cb_benchmark(card)
    phase("cb benchmark", t0)

    t0 = time.perf_counter()
    run_linucb_runner(card)
    phase("linucb runner", t0)

    t0 = time.perf_counter()
    population = run_population(card)
    phase("population", t0)

    t0 = time.perf_counter()
    host_loops = run_host_loops(card)
    phase("host loops", t0)

    t0 = time.perf_counter()
    registry = run_registry_and_checkpoint(card, learning_population)
    phase("registry and checkpoint", t0)

    t0 = time.perf_counter()
    run_examples(card)
    phase("examples", t0)

    t0 = time.perf_counter()
    signal = run_learning_signal(card)
    phase("learning signal and fixed point", t0)

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
            f"driver (summary, {DRV_TIMED} dispatches)": driver["counts"],
            f"curves, sampled ({DRV_TIMED} dispatches)": curves["sampled"]["counts"],
            "curves, lossless (20 dispatches)": curves["lossless"]["counts"],
            "deferred runner (one call)": deferred["counts"],
            "dqn family (1024 envs)": family,
            "packed runner (one call)": packed["counts"],
            "prioritized runner (one call)": prioritized["counts"],
            "masked headline runner (one call)": masked["counts"],
            "offline cql learn (1000 batches)": offline_cql["learn"],
            "offline cql evaluation (16384 env steps)": offline_cql["evaluation"],
            "acrobot runner (one call)": classic["acrobot"]["counts"],
            "mountain car runner (one call)": classic["mountain car"]["counts"],
            f"population ({POP_M} members, {POP_TIMED} dispatches)": population["counts"],
            "host loop (1000 acts at B = 1, 225 learns)": host_loops["counts"],
            "registry rows (39 rows, 4 envs)": registry["fused_mlp"],
            "learning signal, MultiHeadDQN row (32 acts, 60 learns)": signal["fused_mlp"],
            "dp world-1 nccl driver (1 dispatch)": dp_world1["counts"],
            **{f"dp two ranks on cuda:0, rank {r} ({DP_TIMED} dispatches)": c
               for r, c in enumerate(dp_ranks["counts"])},
        },
        "widths": timing["widths"],
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
        by_path = {"registry rows (39 rows, 4 envs)": registry[name],
                   "learning signal, VisualDQN row (32 steps, 90 learns)": signal[name]}
        if any(by_path.values()):
            kernels[-1]["launches_by_path"] = {k: v for k, v in by_path.items() if v}
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
