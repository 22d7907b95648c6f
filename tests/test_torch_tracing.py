"""The port's own spans and counters (`utils/profiling.py`) on a tiny
frame-ring visual DQN run through `online_learning`: the benchmark's pixel
cell cut as its tests cut it (SyntheticAtari 84x84 bfloat16 frames, 4 envs,
batch 32, a learn every 8 steps, two chunks a dispatch), two dispatches in
one call.

On the CPU: tracing off records nothing and changes nothing; the span tree,
the counters, self time and the registry; each span inside the profiler's
range of its name. On the card (`cuda`): the program's clock against the
profiler's, the kernel launches inside the program's record of their span,
a dispatch whose one host sync is the fetch of its statistics, and replay
pushes that never wait for the device."""

import collections
import dataclasses
import json
import statistics

import pytest
import torch

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import SyntheticAtari
from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import TransitionBatch, VisualReplayBuffer
from pearl_tpu_torch.training.online import online_learning
from pearl_tpu_torch.utils import profiling
from pearl_tpu_torch.utils.pytree import compare

B, K, CHUNKS, DISPATCHES, BATCH = 4, 8, 2, 2, 32
STEPS = K * CHUNKS * DISPATCHES
LEARNS = CHUNKS * DISPATCHES
# How far a span's recorded start and end may lie outside the profiler's
# range of the same span. Measured on a CPU host: in 7 runs of 296 spans
# every span lay inside its range, the closest 4 ns from an edge (the
# program reads its clock just inside the range). The tolerance leaves room
# for the error of the profiler's conversion of its approximate clock.
RANGE_TOLERANCE_NS = 5_000


def _agent_and_env(num_envs=B):
    env = SyntheticAtari(height=84, width=84, frames=1, num_actions=6, episode_len=128,
                         obs_dtype=torch.bfloat16)
    learner = DeepQLearning(
        q_network=CNNQValueNetwork(
            input_shape=(84, 84, 4), out_channels=(16, 32), kernel_sizes=(8, 4),
            strides=(4, 2), paddings=(0, 0), hidden_dims=(256,), time_major_stack=True,
        ),
        exploration=EGreedyExploration(epsilon=0.05),
        training_rounds=1,
        batch_size=BATCH,
        target_update_freq=10,
        soft_update_tau=0.75,
        act_dtype="bfloat16",
        history_summarizer=FrameRingHistorySummarization(history_length=4, dtype=torch.bfloat16),
    )
    replay = VisualReplayBuffer(capacity=num_envs * 96, stack=4, num_envs=num_envs,
                                frame_dtype=torch.bfloat16, dedup_next=True)
    return PearlAgent(policy_learner=learner, replay_buffer=replay), env


def _run(device="cpu"):
    agent, env = _agent_and_env()
    return online_learning(
        agent, env, num_envs=B, max_steps=STEPS * B, learn_every_k_steps=K,
        chunks_per_dispatch=CHUNKS, seed=7, stats="summary", device=device,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run with tracing off, then one under `profiling.trace`."""
    profiling.disable()
    profiling.reset()
    off = _run()
    off_records = (profiling.spans(), profiling.counters())
    log_dir = tmp_path_factory.mktemp("trace")
    with profiling.trace(str(log_dir)) as prof:
        on = _run()
    spans, counters = profiling.spans(), profiling.counters()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in profiling.SPANS]
    profiling.reset()
    return dict(off=off, on=on, off_records=off_records, spans=spans, counters=counters,
                events=events, log_dir=log_dir)


def _children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def test_tracing_off_records_nothing_and_changes_nothing(runs):
    assert runs["off_records"] == ([], {})
    assert not profiling._on
    a, b = runs["off"], runs["on"]
    assert compare(a.agent_state, b.agent_state, rtol=0, atol=0) == ""
    assert compare(a.env_states, b.env_states, rtol=0, atol=0) == ""
    assert a.total_steps == b.total_steps and list(a.return_curve) == list(b.return_curve)


def test_off_path_is_one_shared_object():
    profiling.disable()
    assert profiling.span("agent.act") is profiling.span("no.such.span")
    with profiling.span("no.such.span"):
        profiling.count("no.such.counter")
    assert profiling.spans() == [] and profiling.counters() == {}


def test_names_outside_the_registry_raise_when_on():
    profiling.enable()
    try:
        with pytest.raises(ValueError, match="SPANS"):
            profiling.span("agent.acts")
        with pytest.raises(ValueError, match="SPANS"):
            profiling.count("driver.step")
    finally:
        profiling.disable()
        profiling.reset()


def test_every_emitted_name_is_in_the_registry(runs):
    names = {s.name for s in runs["spans"]} | set(runs["counters"])
    assert names <= set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


def test_span_tree(runs):
    spans = runs["spans"]
    by_id = {s.id: s for s in spans}
    kids = _children(spans)
    (call,) = [s for s in spans if s.name == "driver.call"]
    assert call.parent == -1
    dispatches = [s for s in kids[call.id] if s.name == "driver.dispatch"]
    fetches = [s for s in kids[call.id] if s.name == "driver.fetch"]
    assert len(dispatches) == DISPATCHES and len(fetches) == DISPATCHES
    # Each dispatch owns its id; every span under it carries that id.
    assert [d.dispatch for d in dispatches] == list(range(dispatches[0].dispatch,
                                                          dispatches[0].dispatch + DISPATCHES))
    for d in dispatches:
        names = collections.Counter(s.name for s in kids[d.id])
        assert names == {"agent.act": K * CHUNKS, "env.step": K * CHUNKS,
                         "agent.observe": K * CHUNKS, "agent.learn": CHUNKS}
        for s in spans:
            top = s
            while top.parent != -1 and top.name != "driver.dispatch":
                top = by_id[top.parent]
            if top is d:
                assert s.dispatch == d.dispatch
    for s in spans:
        if s.name == "agent.observe":
            assert sorted(c.name for c in kids[s.id]) == ["history.advance", "replay.push"]
        if s.name == "agent.learn":
            assert [c.name for c in kids[s.id]] == ["replay.sample", "learner.update"]
        if s.name.startswith(("history.", "replay.", "learner.")):
            assert by_id[s.parent].name in ("agent.observe", "agent.learn")
        if s.name.startswith("op."):  # under a layer, or the agent's init in the call
            assert by_id[s.parent].name != "driver.dispatch"
    # The acting frame's fence and the ring write run inside history.advance.
    assert {c.name for s in spans if s.name == "history.advance" for c in kids[s.id]} == {
        "op.copy_fence", "op.ring_write_where"}


def test_counters_match_the_spans(runs):
    c, spans = runs["counters"], runs["spans"]
    n = collections.Counter(s.name for s in spans)
    assert c["driver.dispatches"] == n["driver.dispatch"] == DISPATCHES
    assert c["driver.vector_steps"] == n["agent.act"] == STEPS
    assert c["driver.learns"] == n["agent.learn"] == LEARNS
    assert c["replay.rows_pushed"] == B * n["replay.push"] == B * STEPS
    assert c["replay.rows_sampled"] == BATCH * n["replay.sample"] == BATCH * LEARNS
    # The statistics fetch is the only blocking read of a dispatch.
    assert c["driver.host_syncs"] == n["driver.fetch"] == DISPATCHES
    assert set(c) == {"driver.dispatches", "driver.vector_steps", "driver.learns",
                      "replay.rows_pushed", "replay.rows_sampled", "driver.host_syncs"}


def test_self_time_plus_children_is_duration(runs):
    spans = runs["spans"]
    kids = _children(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        inner = sorted((c.start_ns, c.end_ns) for c in kids[s.id])
        for (a0, a1), (b0, _) in zip(inner, inner[1:]):
            assert a1 <= b0  # siblings do not overlap
        assert all(s.start_ns <= a and b <= s.end_ns for a, b in inner)
        covered = sum(b - a for a, b in inner)
        self_ns = (s.end_ns - s.start_ns) - covered
        assert self_ns >= 0 and self_ns + covered == s.end_ns - s.start_ns


def test_spans_lie_inside_the_profiler_ranges(runs):
    theirs = collections.defaultdict(list)
    for name, start, end in runs["events"]:
        theirs[name].append((start, end))
    mine = collections.defaultdict(list)
    for s in runs["spans"]:
        mine[s.name].append((s.start_ns, s.end_ns))
    assert set(theirs) == set(mine)
    for name in mine:
        assert len(mine[name]) == len(theirs[name]), name
        for (s0, s1), (p0, p1) in zip(sorted(mine[name]), sorted(theirs[name])):
            assert p0 - RANGE_TOLERANCE_NS <= s0 <= s1 <= p1 + RANGE_TOLERANCE_NS, name


def test_trace_writes_the_spans_beside_the_trace(runs):
    d = runs["log_dir"]
    assert (d / "trace.json").is_file()
    written = json.load(open(d / "spans.json"))
    assert written["clock"] == "unix_ns"
    assert [tuple(r.values()) for r in written["spans"]] == [tuple(s) for s in runs["spans"]]
    assert written["counters"] == runs["counters"]


@pytest.mark.cuda
def test_program_clock_and_launches_match_the_profiler_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace is the card's")
    from torch.autograd import DeviceType

    _run("cuda")  # builds the kernels and warms every shape
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiling.enable()
        try:
            _run("cuda")
        finally:
            profiling.disable()
        torch.cuda.synchronize()
    spans, counters, sites = profiling.spans(), profiling.counters(), profiling.host_syncs_by_span()
    profiling.reset()
    events = list(prof.profiler.kineto_results.events())
    ranges = collections.defaultdict(list)
    launches = {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in profiling.SPANS:
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif "LaunchKernel" in e.name():
            launches[e.correlation_id()] = e.start_ns()
    mine = collections.defaultdict(list)
    for s in spans:
        mine[s.name].append((s.start_ns, s.end_ns))
    offsets, inside, placed = [], 0, 0
    for name in mine:
        pairs = list(zip(sorted(mine[name]), sorted(ranges[name])))
        assert len(mine[name]) == len(ranges[name]), name
        offsets += [abs(s0 - p0) for (s0, _), (p0, _) in pairs]
        for (s0, s1), (p0, p1) in pairs:
            for t in launches.values():
                if p0 <= t <= p1:
                    placed += 1
                    inside += s0 <= t <= s1
    assert statistics.median(offsets) <= 10_000
    assert placed > 0 and inside >= 0.99 * placed
    # Each fetch counts once; every other sync is named by the span it came from.
    assert sites["driver.fetch"] == DISPATCHES and set(sites) <= set(profiling.SPANS)
    assert counters["driver.host_syncs"] == sum(sites.values())


@pytest.mark.cuda
def test_syncs_inside_spans_are_caught_and_counted_once_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's sync debug mode")
    t = torch.zeros(8, dtype=torch.int32, device="cuda")
    profiling.reset()
    profiling.enable()
    try:
        t[3] = 5  # outside every span: the caller's, not counted
        with profiling.span("replay.push"):
            t[3] = 5  # a host scalar into a device tensor: a synchronizing copy
            t[4].fill_(5)  # no sync
        with profiling.span("driver.fetch"):
            profiling.host_read(t)  # counted by the helper, not again by the warning
    finally:
        profiling.disable()
    assert profiling.host_syncs_by_span() == {"replay.push": 1, "driver.fetch": 1}
    assert profiling.counters() == {"driver.host_syncs": 2}
    assert torch.cuda.get_sync_debug_mode() == 0
    profiling.reset()


@pytest.mark.cuda
def test_a_pixel_dispatch_syncs_the_host_only_at_its_fetch_on_card():
    """One `online_learning` call of one dispatch at 64 envs, carrying the
    state of a warm call as the benchmark's window does: the fetch of its
    statistics is its one host sync, so the host can queue the dispatch's
    steps ahead of the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's sync debug mode")
    envs = 64
    agent, env = _agent_and_env(envs)
    kw = dict(num_envs=envs, max_steps=K * CHUNKS * envs, learn_every_k_steps=K,
              chunks_per_dispatch=CHUNKS, stats="summary", device="cuda")
    warm = online_learning(agent, env, seed=7, **kw)  # builds the kernels, fills the replay
    torch.cuda.synchronize()
    profiling.reset()
    profiling.enable()
    try:
        res = online_learning(agent, env, seed=8, agent_state=warm.agent_state,
                              env_states=warm.env_states, **kw)
    finally:
        profiling.disable()
    sites, counters = profiling.host_syncs_by_span(), profiling.counters()
    profiling.reset()
    assert sites == {"driver.fetch": 1}
    assert counters["driver.host_syncs"] == 1
    assert counters["driver.learns"] == CHUNKS and counters["driver.dispatches"] == 1
    assert res.agent_state.replay.push_count == 2 * K * CHUNKS


def _pushes(n, envs, frame, device):
    """(frame_s, frame_n, rest) of `n` pushes with episode ends among them."""
    gen = torch.Generator().manual_seed(3)
    out = []
    for p in range(n):
        ends = torch.rand((2, envs), generator=gen) < 0.2
        rest = TransitionBatch(
            state=None, action=torch.randint(0, 6, (envs, 1), generator=gen).float(),
            reward=torch.rand((envs,), generator=gen), next_state=None,
            terminated=ends[0], truncated=ends[1] & ~ends[0],
            action_index=torch.randint(0, 6, (envs,), generator=gen, dtype=torch.int32),
        )
        frames = torch.rand((2, envs, frame), generator=gen) * 255
        out.append((frames[0].to(device), frames[1].to(device),
                    TransitionBatch(**{k: None if v is None else v.to(device)
                                       for k, v in vars(rest).items()})))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dedup_next", [False, True])
def test_replay_pushes_never_wait_for_the_card(dedup_next):
    """`push_frames` through a ring of 5 slabs, 11 pushes (two wraps), on the
    card under `set_sync_debug_mode("error")`: no push may wait for the
    device, and the storage equals that of the same pushes on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA's sync debug mode")
    envs, frame, n = 8, 12, 11
    buf = VisualReplayBuffer(capacity=5 * envs, stack=4, num_envs=envs,
                             frame_dtype=torch.bfloat16, dedup_next=dedup_next)
    states = {}
    for device in ("cuda", "cpu"):
        example = _pushes(1, 1, 4 * frame, device)[0]
        state = buf.init(dataclasses.replace(example[2], state=example[0], next_state=example[1]))
        pushes = _pushes(n, envs, frame, device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for frame_s, frame_n, rest in pushes:
                state = buf.push_frames(state, frame_s, frame_n, rest)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        states[device] = state
    assert states["cuda"].push_count == states["cpu"].push_count == n
    assert states["cuda"].storage["seq"].tolist() == [10, 6, 7, 8, 9]
    for name in ("seq", "frame_s", "frame_t" if dedup_next else "frame_n"):
        assert torch.equal(states["cuda"].storage[name].cpu(), states["cpu"].storage[name]), name
    for field in ("reward", "terminated", "truncated", "action_index"):
        assert torch.equal(getattr(states["cuda"].storage["rest"], field).cpu(),
                           getattr(states["cpu"].storage["rest"], field)), field
