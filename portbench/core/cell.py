"""One run of one cell: set-up, the measured window, the traced readings and
the comparison with the reference.

Set-up builds the agent and its state once (the replay allocated at the
configuration's capacity), loads the benchmark's weights, made on the device
from the seed, and runs the driver's dispatches until the replay has
wrapped once. Those dispatches go through the same call as the window's;
the agent's `Recorder` (`agents/<agent>.py`) reads back what the comparison
needs of them, between dispatches and outside `setup_s`. The window then runs one dispatch a call,
carrying the agent's and the envs' state from call to call, until
`seconds` have passed; it ends with the fetch of the last dispatch's
statistics. A traced run times the window with the spans installed, then
profiles two more dispatches with device activity alone (busy and idle
time) and two with host activity too (what each span launched); once the
peak memory is read, it runs the program's own traced phase
(`program.run_phase`: four dispatches with the port's spans and counters on).
Once the program's state is freed, the reference's
`judge` (`reference/<reference>.py`) runs over set-up's seeds and returns
the numbers compared; the cell's limits decide `correct`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.core import compare, program, specs
from portbench.core.spans import LAYER_SPANS, OP_PREFIX, Spans


@dataclasses.dataclass
class Readings:
    """What the metric readers read (`metrics/<name>.py`)."""

    config: dict
    window_s: float  # the measured window, host clock
    vector_steps: int  # vector steps in the window
    learns: int  # learns in the window
    env_steps: int
    host_s: Dict[str, float]  # host seconds in each span over the window (traced runs)
    profile: Optional[object] = None  # trace.Profile, host and device activity
    device_profile: Optional[object] = None  # trace.Profile, device activity only
    profiled_steps: int = 0
    profiled_learns: int = 0
    op_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)  # over the profile
    # The ops' operations over the profile, as seconds at their precision's peak.
    op_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    tf32: Dict[str, bool] = dataclasses.field(default_factory=dict)
    program: Optional[object] = None  # program.Phase, the port's own spans (traced runs)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def call_seed(seed: int, i: int) -> int:
    """The driver's seed for call `i` of a run."""
    return (int(seed) << 16) + i


def weight_seed(seed: int) -> int:
    return (int(seed) << 16) + 0xFFFF


def print_seed(seed: int) -> int:
    """The seed of the frame prints' weights."""
    return (int(seed) << 16) + 0xFFFE


def check_envs(seed: int, num_envs: int, n: int, device) -> torch.Tensor:
    """The envs whose frames are compared whole, drawn from the seed."""
    sample = torch.randperm(num_envs, generator=torch.Generator().manual_seed(int(seed)))
    return sample[: min(n, num_envs)].sort().values.to(device)


def setup_dispatches(config: dict, traffic: dict) -> int:
    """Set-up's dispatches: until the replay has wrapped once, so that the
    learns of the last one sample a wrapped replay, as the window's do."""
    pushes = traffic["learn_every_k_steps"] * traffic["chunks_per_dispatch"]
    return config["replay"]["capacity"] // traffic["num_envs"] // pushes + 1


def run(cell: specs.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, metric_names: Dict[str, List[str]]) -> dict:
    """One run; returns the result object (without the JAX check)."""
    from pearl_tpu_torch.training.online import online_learning

    cfg, traffic = cell.config, cell.traffic
    builder = importlib.import_module(f"portbench.core.agents.{cfg['agent']}")
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    rspec = reference.Spec.from_config(cfg)
    B = traffic["num_envs"]
    k, chunks = traffic["learn_every_k_steps"], traffic["chunks_per_dispatch"]
    learn = traffic["learn"]
    steps_per_dispatch = k * chunks
    env_steps_per_dispatch = B * steps_per_dispatch
    fill = setup_dispatches(cfg, traffic)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---------------------------------------------------------------- set-up
    log(f"imports done at {time.perf_counter() - t_start:.3f} s")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        log(f"CUDA context made at {time.perf_counter() - t_start:.3f} s")
    agent, env = builder.build(cfg, B)
    state = builder.init_state(agent, env, B, seed, device)
    sync()
    log(f"state allocated at {time.perf_counter() - t_start:.3f} s")
    init = reference.init_weights(rspec, weight_seed(seed), device)
    builder.load_weights(state.learner, init)
    calls = 0
    env_states = None

    def dispatch():
        nonlocal state, env_states, calls
        res = online_learning(
            agent, env, num_envs=B, max_steps=env_steps_per_dispatch, learn_every_k_steps=k,
            chunks_per_dispatch=chunks, seed=call_seed(seed, calls), learn=learn,
            agent_state=state, env_states=env_states, stats=traffic["stats"],
            target_return=traffic["target_return"], device=device,
        )
        state, env_states = res.agent_state, res.env_states
        calls += 1
        return res.total_steps

    # What the comparison reads of set-up is read back between its
    # dispatches; that time is the check's, not set-up's.
    keep, stage = reference.judged_learns(rspec, traffic, fill)
    recorder = builder.Recorder(rspec, traffic, print_seed(seed),
                                check_envs(seed, B, traffic["check_envs"], device), keep, stage)
    check_s = 0.0
    recorder.install()
    try:
        for i in range(fill):
            dispatch()
            sync()
            t_read = time.perf_counter()
            recorder.after_dispatch(i, state, env_states)
            sync()
            check_s += time.perf_counter() - t_read
            log(f"set-up dispatch {i} done at {time.perf_counter() - t_start:.3f} s")
    finally:
        recorder.remove()
    t_read = time.perf_counter()
    prog = recorder.outputs(state, env_states, fill)
    sync()
    check_s += time.perf_counter() - t_read
    setup_s = time.perf_counter() - t_start - check_s
    log(f"set-up {setup_s:.3f} s (the check's reads, {check_s:.3f} s, left out)")

    # ---------------------------------------------------------------- window
    spans = Spans(specs.byte_counter, specs.flop_counter) if trace else None
    if spans is not None:
        spans.install()
    try:
        n0 = calls
        t0 = time.perf_counter()
        env_steps = 0
        while True:
            env_steps += dispatch()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        window_calls = calls - n0
        readings = Readings(
            config=cfg, window_s=window_s, vector_steps=window_calls * steps_per_dispatch,
            learns=window_calls * chunks if learn else 0, env_steps=env_steps,
            host_s=dict(spans.host) if spans else {},
            tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn": torch.backends.cudnn.allow_tf32},
        )
        if spans is not None and on_card:
            from portbench.core import trace as trace_mod

            names = set(LAYER_SPANS) | {OP_PREFIX + op for op in _op_names()}
            readings.device_profile = trace_mod.profile(
                lambda: (dispatch(), dispatch()), names, host=False)
            spans.reset()
            readings.profile = trace_mod.profile(lambda: (dispatch(), dispatch()), names)
            readings.profiled_steps = 2 * steps_per_dispatch
            readings.profiled_learns = 2 * chunks if learn else 0
            readings.op_bytes = dict(spans.op_bytes)
            readings.op_flops = dict(spans.op_flops)
    finally:
        if spans is not None:
            spans.remove()
    sync()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    log(f"window {window_s:.3f} s, {window_calls} dispatches; peak {memory_peak} bytes")
    readings.program = program.run_phase(dispatch) if trace and on_card else None

    # ------------------------------------------------------------- the check
    t_check = time.perf_counter()
    del state, env_states
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    detail: dict = {}
    values = reference.judge(rspec, traffic, [call_seed(seed, i) for i in range(fill)],
                             print_seed(seed), prog, init, device, detail)
    for name, per_leaf in detail.items():
        log(f"{name} by learn or leaf: {per_leaf}")
    limits = cell.limits
    correct = compare.verdict(values, limits)
    checks = {name: {"value": values[name], "limit": limits.get(name)} for name in values}
    log(f"reference and comparison {time.perf_counter() - t_check:.3f} s")

    if trace:
        metrics = {}
        for name in metric_names["per_layer"]:
            value = specs.metric_reader(name)(readings)
            if value is not None:
                metrics[name] = value
    else:
        metrics = {"setup_s": setup_s, "env_steps_per_s": env_steps / window_s}
        metrics = {n: metrics[n] for n in metric_names["end_to_end"]}
    return {"correct": correct, "attempted": window_calls, "failed": 0,
            "metrics": metrics, "readings": readings, "memory_peak_bytes": memory_peak,
            "checks": checks}


def _op_names() -> List[str]:
    from pearl_tpu_torch import ops

    return [op for op in ops.__all__ if not op.endswith("_reference")]
