"""The port's example scripts (`examples_torch/`) against the reference's
(`examples/`), one case a script.

- Config parity: each script's driver (`online_learning`,
  `population_learning`, `run_bandit_benchmark`, `run_cb_benchmark_suite`
  and `run_offline_cb_experiment`, `agent_online_learning_host`) is wrapped
  in both packages to record its arguments and return a stand-in result (or
  stop, for the mesh scripts): the agent trees (class names, field names
  and every hyperparameter's value), the env's class and shape
  parameters (not its draws) and the driver's keyword arguments agree.
  Values that scale with the mesh width are compared per rank: the
  reference runs on every device of this host, the port on a world of one.
- A tiny run: `main(device="cpu")` at the reference smoke test's budget
  (2048 steps on 8 envs, the last 256 of them learning), the bandits at 64
  steps, the CB suite at T = 40
  without the offline protocol, Atari against the scripted image fake with
  a small replay; each prints its line, and the mesh scripts leave no
  process group behind (their world of one on gloo is closed).
"""

import dataclasses
import enum
import importlib
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

gymnasium = pytest.importorskip("gymnasium")

from test_atari_and_puckworld import FakeALEImage  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = sorted(p.stem for p in (REPO / "examples_torch").glob("*.py"))

# The driver each script calls, by the name it has in the script's namespace.
DRIVERS = {
    "atari_dqn": ["agent_online_learning_host"],
    "cb_benchmark": ["run_cb_benchmark_suite", "run_offline_cb_experiment"],
    "contextual_bandit_linucb": ["run_bandit_benchmark"],
    "population_sweep": ["population_learning"],
}
MESH_SCRIPTS = ("dp_scaling", "multi_chip_dqn")
# Keyword arguments that only the port's drivers take.
PORT_ONLY = {"device", "check_replication"}
# Fields only the port's classes have, at the value the scripts leave them:
# the ring conv is the reference's environment variable, a field here, whose
# default None takes it wherever the card's bfloat16 ring allows.
PORT_ONLY_FIELDS = {"ring_conv": None}
# Keyword arguments that grow with the mesh's width.
PER_RANK = ("num_envs", "max_steps", "learning_starts")
# What each script prints at its end.
LINES = {
    "atari_dqn": "episodes=",
    "cb_benchmark": "NeuralLinTS",
    "contextual_bandit_linucb": "NeuralLinUCB   cumulative regret",
    "dp_scaling": " OK ",
    "dqn_cartpole": "last-20 mean return=",
    "frozen_lake_dqn": "success rate first",
    "multi_chip_dqn": "replica_spread=0.0",
    "population_sweep": "best member: seed",
    "rc_safety_pendulum": "constraint=0.05: return",
    "recommender_system": "BootstrappedDQN+LSTM:",
    "sac_pendulum": "last-20 mean return=",
}


class _Stop(Exception):
    """Raised by a recording driver to end a mesh script at its first call."""


def _reference(name):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(f"examples_torch.{name}")


def _stand_in(driver):
    """A result with what the scripts read after the driver returns."""
    if driver == "online_learning":
        return types.SimpleNamespace(
            reached_target=False, total_steps=0, total_episodes=0,
            episode_returns=np.zeros(20), episode_costs=np.zeros(20),
            agent_state=types.SimpleNamespace(
                safety=types.SimpleNamespace(lagrangian=torch.zeros(()))),
        )
    if driver == "population_learning":
        return types.SimpleNamespace(total_steps=0, num_members=4, total_episodes=np.zeros(4),
                                     recent_returns=np.zeros(4))
    if driver == "run_bandit_benchmark":
        return {"cumulative_regret": np.zeros(1), "regret": np.zeros(100)}
    if driver == "run_offline_cb_experiment":
        return {"source": "twin", "final_avg_regret": 0.0}
    if driver == "agent_online_learning_host":
        return [0.0]
    return {}


def _recorded_calls(mod, name, monkeypatch, **main_kw):
    """Every driver call `mod.main(**main_kw)` makes: (driver, args, kwargs)."""
    calls = []

    def recorder(driver):
        def fn(*args, **kwargs):
            calls.append((driver, args, kwargs))
            if name in MESH_SCRIPTS:
                raise _Stop
            return _stand_in(driver)
        return fn

    for driver in DRIVERS.get(name, ["online_learning"]):
        monkeypatch.setattr(mod, driver, recorder(driver))
    try:
        mod.main(**main_kw)
    except _Stop:
        pass
    return calls


def _describe(x):
    """A dataclass tree as (class name, {field: description}); tensors and
    arrays as their shapes; functions by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _describe(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_describe(v) for v in x]
    if isinstance(x, dict):
        return {k: _describe(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, enum.Enum):
        return x.name
    if hasattr(x, "shape"):
        return ("array", tuple(x.shape))
    if callable(x):
        return getattr(x, "__name__", type(x).__name__)
    return type(x).__name__


def _assert_same_tree(ours, ref, where="agent"):
    """Class names and field names agree everywhere (but PORT_ONLY_FIELDS),
    and every field's value."""
    if isinstance(ref, tuple) and len(ref) == 2 and isinstance(ref[1], dict):
        assert isinstance(ours, tuple) and ours[0] == ref[0], f"{where}: {ours} != {ref}"
        extra = set(ours[1]) - set(ref[1])
        assert set(ref[1]) <= set(ours[1]) and extra <= set(PORT_ONLY_FIELDS), (
            f"{where}: fields {sorted(ours[1])} != {sorted(ref[1])}")
        assert all(ours[1][k] == PORT_ONLY_FIELDS[k] for k in extra), f"{where}: {ours}"
        for key in sorted(ref[1]):
            _assert_same_tree(ours[1][key], ref[1][key], f"{where}.{key}")
        return
    if isinstance(ref, list) and isinstance(ours, list):
        assert len(ours) == len(ref), f"{where}: {ours} != {ref}"
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same_tree(a, b, f"{where}[{i}]")
        return
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), f"{where}: {ours} != {ref}"
        for key in ref:
            _assert_same_tree(ours[key], ref[key], f"{where}.{key}")
        return
    if isinstance(ref, float) or isinstance(ours, float):
        assert ours == pytest.approx(ref, rel=1e-6), f"{where}: {ours} != {ref}"
        return
    if isinstance(ref, tuple) and ref and ref[0] == "array":
        assert ours == ref, f"{where}: shape {ours} != {ref}"
        return
    assert ours == ref, f"{where}: {ours!r} != {ref!r}"


def _env_shape(env):
    """The env's class and its scalar parameters (not its tables or draws)."""
    fields = {}
    if dataclasses.is_dataclass(env):
        for f in dataclasses.fields(env):
            v = getattr(env, f.name)
            if v is None or isinstance(v, (bool, int, float, str)):
                fields[f.name] = v
    for attr in ("num_items", "item_dim", "observation_dim", "num_arms"):
        if hasattr(env, attr):
            fields[attr] = getattr(env, attr)
    return type(env).__name__, fields


def _mesh_width(kwargs):
    mesh = kwargs.get("mesh")
    if mesh is None:
        return 1
    return int(mesh.devices.size) if hasattr(mesh, "devices") else mesh.size


def _comparable(driver, args, kwargs):
    """(agent tree, env shape, keyword arguments) of one driver call, with
    the per-rank values divided by the mesh's width."""
    kwargs = dict(kwargs)
    width = _mesh_width(kwargs)
    kwargs.pop("mesh", None)
    for key in PORT_ONLY:
        kwargs.pop(key, None)
    for key in PER_RANK:
        if key in kwargs:
            kwargs[key] = kwargs[key] / width
    if driver in ("run_cb_benchmark_suite", "run_offline_cb_experiment"):
        return None, None, (args, kwargs)
    agent, env = args[:2]
    return _describe(agent), _env_shape(env), kwargs


@pytest.fixture
def atari_fake(monkeypatch):
    """gymnasium.make gives the scripted image fake (no ROMs here)."""
    monkeypatch.setattr(gymnasium, "make", lambda name, **kw: FakeALEImage())


def test_every_reference_script_has_its_port():
    reference = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert SCRIPTS == reference and len(SCRIPTS) == 11


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_configures_its_driver_as_the_reference(name, monkeypatch, atari_fake, capsys):
    monkeypatch.setattr("sys.argv", [f"{name}.py"])
    ref_calls = _recorded_calls(_reference(name), name, monkeypatch)
    main_kw = {"device": "cpu"}
    if name == "dp_scaling":
        main_kw["ranks"] = 1
    port_calls = _recorded_calls(_port(name), name, monkeypatch, **main_kw)
    assert not dist.is_initialized(), "a script left its world open"
    assert len(port_calls) == len(ref_calls) > 0
    for (driver, args, kwargs), (ref_driver, ref_args, ref_kwargs) in zip(port_calls, ref_calls):
        assert driver == ref_driver
        ours = _comparable(driver, args, kwargs)
        ref = _comparable(ref_driver, ref_args, ref_kwargs)
        _assert_same_tree(ours[0], ref[0])
        assert ours[1] == ref[1]
        assert ours[2] == ref[2]


def _tiny(orig, driver):
    """`orig` at the reference smoke test's budget, learning only at its end
    (the recommender's 100 candidates make a learn of the ensemble slow on
    one core)."""
    def fn(*args, **kw):
        if driver in ("online_learning", "population_learning"):
            kw.update(max_steps=2_048, num_envs=8, learning_starts=1_792)
        elif driver == "run_bandit_benchmark":
            kw.update(steps=64)
        elif driver == "agent_online_learning_host":
            agent = dataclasses.replace(
                args[0], replay_buffer=dataclasses.replace(args[0].replay_buffer, capacity=512))
            args = (agent,) + args[1:]
            kw.update(max_steps=300, learning_starts=64)
        return orig(*args, **kw)
    return fn


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_at_a_tiny_budget_on_the_cpu(name, monkeypatch, atari_fake, capsys):
    mod = _port(name)
    for driver in DRIVERS.get(name, ["online_learning"]):
        monkeypatch.setattr(mod, driver, _tiny(getattr(mod, driver), driver))
    main_kw = {"device": "cpu"}
    if name == "cb_benchmark":
        main_kw.update(t=40, skip_offline=True)
    elif name == "dp_scaling":
        main_kw.update(ranks=1, calls=1, envs_per_device=32)
    out = mod.main(**main_kw)
    printed = capsys.readouterr().out
    assert LINES[name] in printed, printed
    assert not dist.is_initialized(), "a script left its world open"
    if name == "multi_chip_dqn":
        assert out[1] == 0.0 and out[0].agent_state.learner.params is not None
    elif name == "dp_scaling":
        assert [row["devices"] for row in out] == [1] and out[0]["spread"] == 0.0
