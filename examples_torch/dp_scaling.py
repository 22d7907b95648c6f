"""Weak scaling of the production driver over a data-parallel mesh, on the
port (the twin of examples/dp_scaling.py).

Runs `online_learning(agent, env, mesh=...)` — the same user-facing driver
as on one card, with summary-mode episode accounting and early stopping
live — at widths 1/2/4/8 with a FIXED per-rank workload (256 envs, batch
256) and reports aggregate env-steps/s plus a replica check (the learner
params must stay byte for byte equal on every rank: the gradient all-reduce
keeps them in lockstep from a shared init seed).

A rank is a process. Under torchrun (or after `multihost.initialize` in
every process) the script measures one width, the world's size. Started
alone, it measures width 1 in-process and launches itself as N ranks for
every wider width up to the cards it sees (`--ranks` sets the widest; with
`--backend gloo --device cuda:0` the ranks share one card):

    torchrun --nproc_per_node=N -m examples_torch.dp_scaling
    python -m examples_torch.dp_scaling
    python -m examples_torch.dp_scaling --ranks 2 --backend gloo --device cuda:0

Ranks that share a card measure synchronisation, not scaling.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole
from pearl_tpu_torch.parallel import make_mesh, multihost, replica_spread
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import online_learning

ROW = "DP_SCALING_ROW "


def measure(mesh, calls: int = 40, envs_per_device: int = 256):
    """This width's row: aggregate env-steps/s, replica spread and episodes
    on `mesh`."""
    agent = PearlAgent(
        policy_learner=DeepQLearning(training_rounds=1, batch_size=256),
        replay_buffer=BasicReplayBuffer(capacity=8192),
    )
    num_envs = envs_per_device * mesh.size
    steps_per_learn = 8
    common = dict(
        num_envs=num_envs, learn_every_k_steps=steps_per_learn,
        chunks_per_dispatch=4, stats="summary", mesh=mesh,
        target_return=1e9,  # early-stop accounting active, never triggers
    )
    # Warm-up: first launches and allocations outside the timed region.
    warm = online_learning(
        agent, CartPole(), max_steps=num_envs * steps_per_learn * 4,
        seed=0, check_replication=True, **common,
    )
    t0 = time.perf_counter()
    res = online_learning(
        agent, CartPole(),
        max_steps=num_envs * steps_per_learn * 4 * calls,
        seed=1, agent_state=warm.agent_state, **common,
    )
    elapsed = time.perf_counter() - t0  # the result's statistics are on the host
    spread = replica_spread(res.agent_state.learner.params, mesh.axis("data"))
    return {"devices": mesh.size, "sps": res.total_steps / elapsed, "spread": spread,
            "episodes": res.total_episodes}


def _in_world(device, backend, calls, envs_per_device):
    """One width, the world's size: this process is one of its ranks. A
    world this call joined (torchrun's environment) it also leaves."""
    joined = not dist.is_initialized()
    if joined:
        multihost.initialize(backend=backend)
    try:
        with make_mesh(device=device, backend=backend) as mesh:
            row = measure(mesh, calls, envs_per_device)
        if dist.get_rank() == 0:
            print(ROW + json.dumps(row), flush=True)
        return row
    finally:
        if joined:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(width, device, backend, calls, envs_per_device, timeout_s=1800):
    """Run this script as `width` ranks on this host, as torchrun would
    start them, and return rank 0's row."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(width),
               PYTHONPATH=os.pathsep.join(filter(None, [os.path.dirname(here),
                                                        os.environ.get("PYTHONPATH")])))
    args = [sys.executable, os.path.abspath(__file__), "--calls", str(calls),
            "--envs-per-device", str(envs_per_device)]
    args += ["--device", str(device)] if device is not None else []
    args += ["--backend", backend] if backend is not None else []
    children = [
        subprocess.Popen(args, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(width)
    ]
    try:
        outputs = [c.communicate(timeout=timeout_s)[0] for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    for r, (c, out) in enumerate(zip(children, outputs)):
        if c.returncode != 0:
            raise RuntimeError(f"rank {r} of {width} failed ({c.returncode}):\n{out}")
    line = [x for x in outputs[0].splitlines() if x.startswith(ROW)][-1]
    return json.loads(line[len(ROW):])


def main(device=None, ranks=None, backend=None, calls=40, envs_per_device=256):
    """The rows measured, one a width. Inside a world: that world's width
    alone. Started alone: width 1 here, then 2/4/8 up to `ranks` (the
    cards this process sees by default), each as that many processes."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return [_in_world(device, backend, calls, envs_per_device)]
    if ranks is None:
        ranks = torch.cuda.device_count() if torch.cuda.is_available() else 1
    widths = [n for n in (1, 2, 4, 8) if n <= ranks]
    print(f"ranks available: {ranks} ({device or 'cuda:LOCAL_RANK'}, "
          f"{backend or 'nccl on cards, gloo on the CPU'})")
    print(f"{'devices':>8} {'agg steps/s':>14} {'vs 1-dev':>9} {'sync':>6} {'episodes':>9}")
    rows, base = [], None
    for n in widths:
        if n == 1:
            with make_mesh(1, device=device, backend=backend) as mesh:
                row = measure(mesh, calls, envs_per_device)
        else:
            row = _launch(n, device, backend, calls, envs_per_device)
        rows.append(row)
        base = base or row["sps"]
        sync = "OK" if row["spread"] == 0.0 else f"DIVERGED({row['spread']:.1e})"
        print(f"{n:>8} {row['sps']:>14,.0f} {row['sps'] / base:>8.2f}x {sync:>6} "
              f"{row['episodes']:>9}", flush=True)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda:LOCAL_RANK (the default) or cpu")
    p.add_argument("--ranks", type=int, default=None, help="the widest width (started alone)")
    p.add_argument("--backend", default=None, help="nccl on cards, gloo on the CPU or shared")
    p.add_argument("--calls", type=int, default=40)
    p.add_argument("--envs-per-device", type=int, default=256)
    main(**vars(p.parse_args()))
