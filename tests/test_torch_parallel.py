"""The port's distribution layer against the JAX package: `pmean_axis` in
every learner that has it, and ensemble parallelism.

Two ranks of a gloo world (`tests/torch_parallel_worker.py`, spawned once for
the whole file) run each learner's learn step on their halves of a batch;
JAX runs the same learner with `pmean_axis="data"` under `jax.shard_map` on
the two virtual CPU devices of `tests/conftest.py`, each device on the same
half. Both start from the same flax parameters (the loaders of the earlier
slices carry them across) and take the same draws (each learner's noise seam,
drawn from the keys the JAX code splits, at the half batch's size: the JAX
key is replicated, so both devices draw the same numbers). The ranks must be
bit-equal, and rank 0 must equal JAX's device 0 within the learners'
tolerance (rtol 1e-4, atol 1e-5; LinUCB's statistics at the bandit tests'
tolerance, float64 against JAX's float32).

In-process: `online_learning(mesh=make_mesh(1))` equals the solo driver bit
for bit, and `multihost.initialize()` is a no-op without a cluster. A mesh
that made a world of one tears it down at `close()` (every test here closes
the world it makes), and a mesh over a world it did not make leaves it open.
"""

import copy
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as worker
from pearl_tpu.envs import Pendulum as JaxPendulum
from pearl_tpu.policy_learners import contextual_bandits as jcb
from pearl_tpu.policy_learners.exploration_modules import contextual_bandits as jexp
from pearl_tpu.replay_buffers.transition import TransitionBatch as JaxBatch
from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.envs import CartPole, Pendulum
from pearl_tpu_torch.parallel import gather_ensemble_state, make_mesh, multihost
from pearl_tpu_torch.policy_learners.contextual_bandits import LinearBandit, NeuralLinearBandit
from pearl_tpu_torch.policy_learners.exploration_modules import UCBExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import BootstrappedDQN
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer, TransitionBatch
from pearl_tpu_torch.training import online_learning
from pearl_tpu_torch.utils.jax_params import load_flax_neural_linear_state
from pearl_tpu_torch.utils.pytree import compare
from test_torch_actor_critic import _assert_states_close as assert_actor_critic_close
from test_torch_actor_critic import _batch_data as pendulum_data
from test_torch_actor_critic import _learners as actor_critic_learners
from test_torch_bandits import STATS_TOL, _assert_net_close, _assert_stats_close
from test_torch_bandits import _batches as bandit_batches
from test_torch_bandits import _pair as bandit_pair
from test_torch_bandits import _rows, _synthetic_spaces
from test_torch_bootstrapped import _assert_flat_close, _bootstrapped, _stacked_tree
from test_torch_discrete_actor_critic import _assert_sac_close, _sac_batch, _sac_learners
from test_torch_dqn import _batch_data as cartpole_data
from test_torch_dqn import _flax_layout
from test_torch_dqn import _learners as dqn_learners
from test_torch_dqn_family import STEP_TOL
from test_torch_dqn_family import _batch_data as family_data
from test_torch_offline import _assert_iql_close, _iql_batch, _iql_pair
from test_torch_on_policy import (
    _buffers,
    _on_policy_learners,
    _push_all,
    _transitions,
    assert_on_policy_states_close,
    ppo_indices,
)
from test_torch_safety import _assert_rc_close, _rc_pair, _with_lambda

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
ENSEMBLE_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 2


def _halves(data: dict) -> list:
    n = len(data["reward"]) // 2
    return [{k: v[r * n:(r + 1) * n] for k, v in data.items()} for r in range(2)]


def _jax_batch(data):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})


def _port_batch(data):
    return TransitionBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in data.items()})


def jax_dp(fn):
    """`fn` per device on the two virtual devices (`jax.shard_map`, axis
    "data"): called with lists of two per-device pytrees, returns the list
    of the two devices' outputs."""
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("data",))

    def per_device(*args):
        out = fn(*jax.tree.map(lambda x: x[0], args))
        return jax.tree.map(lambda x: x[None], out)

    run = jax.jit(jax.shard_map(per_device, mesh=mesh, in_specs=P("data"),
                                out_specs=P("data"), check_vma=False))

    def call(*per_device_args):
        # Stacked and split on the host: eager JAX would compile a program
        # for every leaf's shape.
        stacked = [jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *a)
                   for a in per_device_args]
        out = jax.device_get(run(*stacked))
        return [jax.tree.map(lambda x: x[i], out) for i in range(2)]

    return call


@dataclasses.dataclass
class Case:
    """One learner: the port's part goes to the ranks (`obj.method(state,
    *args, **kwargs)` step by step, args per rank); the JAX part runs here."""

    obj: object
    state: object
    method: str
    steps: list  # per step: [(args, kwargs) of rank 0, of rank 1]
    jax_fn: object  # (state, *per-device args) -> (state, ..., metrics)
    jax_state: object
    jax_steps: list  # per step: [per-device args of device 0, of device 1]
    check: object  # (jax state of device 0, port state of rank 0) -> None
    metrics: tuple = ()  # scalar metrics that the learners average


def jl_dp(jl):
    return dataclasses.replace(jl, pmean_axis="data")


def _fields(jax_batch) -> dict:
    """A JAX batch's fields as numpy arrays, the absent ones left out."""
    return {k: np.asarray(v) for k, v in dataclasses.asdict(jax_batch).items() if v is not None}


def _learn_batch_case(jl, jstate, tl, tstate, data, check, noise=None, metrics=()):
    """`learn_batch` of each step (`data`: the two halves of each step's
    batch; `noise`: each step's draws, the same on both ranks)."""
    return Case(
        obj=tl, state=tstate, method="learn_batch",
        steps=[[((_port_batch(h),), {} if noise is None else {"noise": noise[i]}) for h in d]
               for i, d in enumerate(data)],
        jax_fn=lambda s, b: jl_dp(jl).learn_batch(s, b), jax_state=jstate,
        jax_steps=[[(_jax_batch(h),) for h in d] for d in data], check=check, metrics=metrics,
    )


def _dqn_case(name):
    jl, jstate, tl, tstate = dqn_learners(name)

    def check(js, ts):
        ref = jax.tree.map(np.asarray, js.params)
        ours = _flax_layout(ts.params)
        for layer in ref["MLP_0"]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_allclose(ours["MLP_0"][layer][leaf], ref["MLP_0"][layer][leaf],
                                           err_msg=f"{layer}.{leaf}", **TOL)
        assert ts.step == int(js.step) == STEPS

    data = [_halves(cartpole_data(64, seed=s)) for s in range(STEPS)]
    return _learn_batch_case(jl, jstate, tl, tstate, data, check, metrics=("loss",))


def _normal(key, n=16, width=1):
    return torch.tensor(np.asarray(jax.random.normal(key, (n, width))))


@functools.lru_cache(maxsize=None)
def _built_actor_critic_pair(name):
    return actor_critic_learners(name)


def _actor_critic_pair(name):
    """`actor_critic_learners(name)`, built once for the CSAC case and the
    RCPO case's learner; the port state copied for each (a rank writes the
    CSAC case's in place before the RCPO case reads its own)."""
    jl, jstate, tl, tstate = _built_actor_critic_pair(name)
    return jl, jstate, tl, copy.deepcopy(tstate)


def _actor_critic_case(name):
    """The noise of each step comes from the state key that step starts
    from, the same on both devices; a learn step leaves split(key, 3)[0]
    (actor_critic_base.py:242-243)."""
    jl, jstate, tl, tstate = _actor_critic_pair(name)
    noise, key = [], jstate.key
    for _ in range(STEPS):
        k_next, k_actor, k_critic = jax.random.split(key, 3)
        noise.append({"actor": _normal(k_actor), "critic": _normal(k_critic),
                      "target": _normal(k_critic),
                      "alpha": _normal(jax.random.fold_in(k_next, 1))})
        key = k_next
    data = [_halves(pendulum_data(s)) for s in range(STEPS)]
    return _learn_batch_case(jl, jstate, tl, tstate, data, assert_actor_critic_close, noise)


def _sac_case():
    jl, jstate, tl, tstate, dim = _sac_learners("mlp")
    data = [_halves(_fields(_sac_batch(s, dim, 1.0)[0])) for s in range(STEPS)]
    shaky = {"actor": {}, "critic": {}}
    return _learn_batch_case(jl, jstate, tl, tstate, data,
                             lambda js, ts: _assert_sac_close(js, ts, 3e-3, shaky))


def _on_policy_case(name):
    T, n = 4, 3  # steps of the rollout, envs a rank
    jl, jstate, tl, tstate, dim = _on_policy_learners(name, "vanilla")
    steps, jax_steps = [], []
    for learn in range(STEPS):
        pushes = _transitions(learn, T, 2 * n, dim, 3)
        port_args, jax_args = [], []
        for r in range(2):
            jbuf, jbs, tbuf, tbs = _buffers(T, n, dim)
            mine = [{k: v[r * n:(r + 1) * n] for k, v in p.items()} for p in pushes]
            jbs, tbs = _push_all(jbuf, jbs, tbuf, tbs, mine)
            key = jax.random.PRNGKey(10 + 2 * learn + r)
            indices = ppo_indices(tl, key, T * n) if name == "ppo" else None
            port_args.append(((tbuf, tbs, None), {"indices": indices}))
            jax_args.append((jbs, key))
        steps.append(port_args)
        jax_steps.append(jax_args)
    jbuf = _buffers(T, n, dim)[0]
    return Case(
        obj=tl, state=tstate, method="learn", steps=steps,
        jax_fn=lambda s, bs, k: jl_dp(jl).learn(s, jbuf, bs, k), jax_state=jstate,
        jax_steps=jax_steps, check=assert_on_policy_states_close,
    )


def _iql_case():
    jl, jstate, tl, tstate, obs_dim = _iql_pair("pendulum")
    data = [_halves(_fields(_iql_batch(s, "pendulum", obs_dim, False)[0]))
            for s in range(STEPS)]
    return _learn_batch_case(jl, jstate, tl, tstate, data, _assert_iql_close)


def _rc_case():
    """_continuous_case's RCPO update on CSAC, its learners those of the CSAC
    case."""
    jl, jls, tl, tls = _actor_critic_pair("csac_autotune")
    spaces = (JaxPendulum().action_space, Pendulum().action_space)
    jrc, js, trc, ts = _rc_pair(3, spaces, constraint_value=0.1)
    js, ts = _with_lambda(js, ts, 0.3)
    data = []
    for s in range(STEPS):  # _continuous_case's batches, without its learners
        d = pendulum_data(s)
        d["cost"] = np.random.default_rng(s + 7).random(len(d["reward"])).astype(np.float32)
        data.append(_halves(d))
    steps, key = [], js.key
    for d in data:
        # An update leaves split(key, 3)[2] (reward_constrained.py:129, 201).
        k_next, k_lam, key = jax.random.split(key, 3)
        noise = {"next": _normal(k_next), "lambda": _normal(k_lam)}
        steps.append([((_port_batch(h), tl, tls), {"noise": noise}) for h in d])
    return Case(
        obj=trc, state=ts, method="_update_from_batch", steps=steps,
        jax_fn=lambda s, b: dataclasses.replace(jrc, pmean_axis="data")._update_from_batch(
            s, b, jl, jls),
        jax_state=js, jax_steps=[[(_jax_batch(h),) for h in d] for d in data],
        check=_assert_rc_close,
    )


def _bandit_data(env, seed, n=32):
    rows = _rows(seed, n, 4, env.action_space.n)
    return _halves(_fields(bandit_batches(rows, env.arm_features.numpy())[0]))


def _linucb_case():
    jenv, env = _synthetic_spaces()
    jl, tl, jstate, tstate = bandit_pair(
        jcb.LinearBandit(exploration=jexp.UCBExploration(alpha=1.0), l2_reg_lambda=0.5),
        LinearBandit(exploration=UCBExploration(alpha=1.0), l2_reg_lambda=0.5),
        env.action_space, jenv.action_space, 4)
    data = [_bandit_data(env, s) for s in range(STEPS)]
    return _learn_batch_case(jl, jstate, tl, tstate, data,
                             lambda js, ts: _assert_stats_close(ts.model, js.model, STATS_TOL))


def _neural_linear_case():
    jenv, env = _synthetic_spaces()
    cfg = dict(hidden_dims=(16,), linear_feature_dim=6, learning_rate=0.01)
    jl, tl, jstate, tstate = bandit_pair(
        jcb.NeuralLinearBandit(exploration=jexp.UCBExploration(alpha=2.0), **cfg),
        NeuralLinearBandit(exploration=UCBExploration(alpha=2.0), **cfg),
        env.action_space, jenv.action_space, 4)
    tstate = load_flax_neural_linear_state(tstate, jax.tree.map(np.asarray, dict(
        mlp=jstate.mlp_params, head=jstate.head_params, linreg=jstate.linreg)))
    shaky = {}

    def check(js, ts):
        _assert_net_close(torch.nn.ModuleDict({"mlp": ts.mlp_params, "head": ts.head_params}),
                          ts.optimizer, {"mlp": js.mlp_params, "head": js.head_params},
                          js.opt_state, 0.01, shaky)
        _assert_stats_close(ts.linreg, js.linreg, TOL)

    data = [_bandit_data(env, 20 + s) for s in range(STEPS)]
    return _learn_batch_case(jl, jstate, tl, tstate, data, check)


CASES = {
    "dqn": lambda: _dqn_case("dqn_vanilla"),
    "cql": lambda: _dqn_case("cql_multihead"),
    "csac": lambda: _actor_critic_case("csac_autotune"),
    "discrete_sac": _sac_case,
    "td3": lambda: _actor_critic_case("td3"),
    "ppo": lambda: _on_policy_case("ppo"),
    "reinforce": lambda: _on_policy_case("reinforce"),
    "iql": _iql_case,
    "rcpo": _rc_case,
    "linucb": _linucb_case,
    "neural_linear_bandit": _neural_linear_case,
}

K = 4  # the ensemble's members


def _ensemble_inputs():
    jl, jstate, tl, tstate = _bootstrapped(K)
    rng = np.random.default_rng(0)
    batches = []
    for step in range(STEPS):
        data = family_data(64, seed=step)
        del data["next_action"], data["next_action_index"]
        data["bootstrap_mask"] = (rng.random((64, K)) < 0.5).astype(np.float32)
        batches.append(data)
    indivisible = BootstrappedDQN(q_network=dataclasses.replace(tl.q_network, ensemble_size=3))
    return dict(jl=jl, jstate=jstate, tl=tl, tstate=tstate, batches=batches,
                indivisible=indivisible)


class _Ranks:
    """The two ranks of this file, started first (they import while the
    cases are built); the JAX side of each case runs in a thread of this
    process as soon as the case is built, while the next cases are built and
    the ranks compute. `results` waits for the ranks,
    `jax_outputs(name)` for a case's JAX run."""

    def __init__(self, directory):
        self.directory = directory
        self.context = worker.start("learn", directory)
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.cases, self.jax = {}, {}
        try:
            for name, make in CASES.items():
                self.cases[name] = make()
                self.jax[name] = self.pool.submit(_run_jax, self.cases[name])
            self.ensemble = e = _ensemble_inputs()
            worker.send("learn", directory, {
                "learn": {name: {"obj": c.obj, "state": c.state, "method": c.method,
                                 "steps": c.steps} for name, c in self.cases.items()},
                "ensemble": {"learner": e["tl"], "state": e["tstate"],
                             "batches": [_port_batch(b) for b in e["batches"]],
                             "indivisible": e["indivisible"]},
            })
        except BaseException:
            worker.stop(self.context)
            self.pool.shutdown()
            raise
        self._results = None

    def jax_outputs(self, name):
        return self.jax[name].result()

    @property
    def results(self):
        if self._results is None:
            self._results = worker.finish(self.context, "learn", self.directory)
        return self._results


def _run_jax(case):
    """Per step: the two devices' outputs."""
    run = jax_dp(case.jax_fn)
    js, outputs = [case.jax_state] * 2, []
    for jargs in case.jax_steps:
        outs = run(js, *zip(*jargs))
        js = [out[0] for out in outs]
        outputs.append(outs)
    return outputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("parallel_learn"))
    yield r
    r.pool.shutdown()


def _assert_bit_equal(a, b):
    assert compare(a, b, rtol=0, atol=0) == ""


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_learn_equals_jax_two_device_pmean_learn(ranks, name):
    case = ranks.cases[name]
    outputs = ranks.jax_outputs(name)
    port = [r["learn_steps"][name] for r in ranks.results]
    _assert_bit_equal(port[0]["state"], port[1]["state"])
    case.check(outputs[-1][0][0], port[0]["state"])
    for step in range(STEPS):
        for k in case.metrics:  # averaged: the same on every rank and device
            for r in range(2):
                np.testing.assert_allclose(port[r]["metrics"][step][k].item(),
                                           float(outputs[step][r][-1][k]), err_msg=k, **TOL)


def test_ensemble_sharded_learn_equals_unsharded_and_jax(ranks):
    e = ranks.ensemble
    tl, jl = e["tl"], e["jl"]
    unsharded, jstate = copy.deepcopy(e["tstate"]), e["jstate"]
    learn = jax.jit(jl.learn_batch)
    ref_metrics = []
    for data in e["batches"]:
        unsharded, m = tl.learn_batch(unsharded, _port_batch(data))
        ref_metrics.append(m)
        jstate, _ = learn(jstate, _jax_batch(data))
    out = [r["ensemble"] for r in ranks.results]
    # (1, 2): the members split over the model axis; joined, the unsharded learn.
    by_model = sorted((o[(1, 2)] for o in out), key=lambda o: o["model_rank"])
    joined = gather_ensemble_state(tl, [o["state"] for o in by_model])
    assert compare(joined, unsharded, **ENSEMBLE_TOL) == ""
    _assert_flat_close(_stacked_tree(joined.params), jstate.params, STEP_TOL)
    _assert_flat_close(_stacked_tree(joined.target_params), jstate.target_params, STEP_TOL)
    for o in by_model:
        assert next(o["state"].params.parameters()).shape[0] == K // 2
        for mine, ref in zip(o["metrics"], ref_metrics):
            np.testing.assert_allclose(mine["loss"].item(), ref["loss"].item(), **ENSEMBLE_TOL)
            np.testing.assert_allclose(mine["per_sample_td"].numpy(),
                                       ref["per_sample_td"].numpy(), **ENSEMBLE_TOL)
    # (2, 1): the batch split over the data axis, every member on each rank.
    for o in out:
        sharded = o[(2, 1)]
        assert compare(sharded["state"], unsharded, **ENSEMBLE_TOL) == ""
        d, n = sharded["data_rank"], 64 // 2
        for mine, ref in zip(sharded["metrics"], ref_metrics):
            np.testing.assert_allclose(mine["loss"].item(), ref["loss"].item(), **ENSEMBLE_TOL)
            np.testing.assert_allclose(mine["per_sample_td"].numpy(),
                                       ref["per_sample_td"][d * n:(d + 1) * n].numpy(),
                                       **ENSEMBLE_TOL)


def test_ensemble_sharding_rejects_an_indivisible_ensemble(ranks):
    for r in ranks.results:
        assert "must divide" in r["ensemble"]["indivisible"]


def _online_agent():
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning

    return PearlAgent(policy_learner=DeepQLearning(training_rounds=1, batch_size=16),
                      replay_buffer=BasicReplayBuffer(capacity=256))


@pytest.mark.parametrize("stats", ["summary", "full", "curves"])
def test_mesh_of_one_is_the_solo_driver_bit_for_bit(stats):
    kw = dict(num_envs=8, max_steps=1024, learn_every_k_steps=4, chunks_per_dispatch=2, seed=3,
              stats=stats, curve_capacity=64, target_return=25.0, target_window=4)
    solo = online_learning(_online_agent(), CartPole(), device="cpu", **kw)
    with make_mesh(1, device="cpu") as world_of_one:
        mesh = online_learning(_online_agent(), CartPole(), mesh=world_of_one,
                               check_replication=True, **kw)
    _assert_bit_equal(mesh.agent_state, solo.agent_state)
    _assert_bit_equal(mesh.env_states, solo.env_states)
    for field in ("total_steps", "total_episodes", "reached_target", "mean_return",
                  "episodes_dropped"):
        assert getattr(mesh, field) == getattr(solo, field), field
    for field in ("episode_returns", "episode_costs", "return_curve"):
        a, b = getattr(mesh, field), getattr(solo, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    assert solo.total_episodes > 0


def test_a_mesh_of_more_ranks_than_the_world_names_the_launch():
    with make_mesh(1, device="cpu"):  # a world of one, closed at the end
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
            make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        make_mesh(2, device="cpu")  # and with no world at all


def test_a_mesh_tears_down_the_world_it_made_and_no_other():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    mesh.close()
    assert not dist.is_initialized()
    mesh.close()  # twice is a no-op
    assert not dist.is_initialized()
    with make_mesh(1, device="cpu") as again:  # a second world of one works
        assert again.axis("data").size == 1 and dist.is_initialized()
        # A mesh over a world it did not make leaves that world open.
        other = make_mesh(1, device="cpu")
        other.close()
        with make_mesh(1, device="cpu"):
            pass
        assert dist.is_initialized() and dist.group.WORLD is again.world
    assert not dist.is_initialized()
    # A world this process joined itself (as torchrun's) outlives every mesh.
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with make_mesh(1, device="cpu") as joined:
            assert joined.world is None
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_multihost_initialize_is_a_no_op_without_a_cluster(monkeypatch):
    import torch.distributed as dist

    for name in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    before = dist.is_initialized() and dist.get_world_size()
    assert multihost.initialize() is None
    assert (dist.is_initialized() and dist.get_world_size()) == before
    assert multihost.process_index() == 0
    assert multihost.local_device_count() >= 1
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1234")


def test_pmean_axis_averages_nothing_alone():
    """A learner's gradient step with the axis of a mesh of one is its step
    without one, bit for bit."""
    jl, _, tl, tstate = dqn_learners("dqn_vanilla")
    other = copy.deepcopy(tstate)
    batch = _port_batch(cartpole_data(64, seed=5))
    a, ma = tl.learn_batch(tstate, batch)
    with make_mesh(1, device="cpu") as mesh:
        b, mb = dataclasses.replace(tl, pmean_axis=mesh.axis("data")).learn_batch(other, batch)
    _assert_bit_equal(a, b)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["per_sample_td"], mb["per_sample_td"])
