"""Env steps each package needs to reach its target with the configurations
of tests/integration/test_convergence.py: CartPole 500 with the multi-head
Q-network (:48-79, the learning phase of chip_smoke.py), with Double DQN,
Dueling DQN, QR-DQN, deep SARSA or online CQL (:82-121), or with discrete
SAC, PPO or REINFORCE
(:124-158), Pendulum -250 with continuous SAC, DDPG or TD3 (:62-71,
:161-187), HER on the sparse reach task (:193-219: the success share of
the last 200 episodes, which the reference holds above 0.95), and DQN with an
LSTM or a transformer summarizer on CartPole that shows positions only
(tests/test_wrappers_and_history.py:106-134 and
tests/test_risk_sensitive_and_transformer.py:139-170: the mean return of the
last tenth of the episodes, which the reference holds above 100); and the
offline pipelines (`--env offline`, see OFFLINE_LEARNERS); and the anchors of
the remaining envs (see ENV_ANCHORS): DQN on FrozenLake
(test_convergence.py:266-286, return 1.0 five episodes in a row), tabular Q
on FrozenLake (tests/test_misc_components.py:51-75, its greedy table reaches
the goal), DQN on Catcher (tests/test_ple_envs.py:175-202), DQN on the
recommender (tests/test_recsys.py:57-80) and QR-DQN on the mean-variance
bandit (tests/test_risk_sensitive_and_transformer.py:22-59); and the
reference's UCI CB suite (`--env cb_suite`: every CB method on every dataset,
T = 5000 over 10 envs, benchmarks/cb.py's `run_cb_benchmark_suite`; the
final_avg_regret of each cell); and every registry row's learning signal on
frozen targets (`--env learning_signal`: its loss's late / early ratio
against the thresholds of tests/test_learning_signal_matrix.py). `--mesh N` runs a CartPole or Pendulum
learner data-parallel over N ranks: the JAX package on N virtual CPU devices
(`make_mesh(N)`), the port in N processes joined by gloo (on `--device`, which
the ranks share); `--learner mesh_dqn --mesh 2` is the mesh anchor
(test_convergence.py:289-316: DQN with the default Q-network on 16 envs over
2 devices), which also prints the learner replicas' spread at the end (0.0:
bit-identical). Not collected by pytest; run it:

    python tests/torch_port_convergence.py --package jax --seeds 42
    python tests/torch_port_convergence.py --package torch --seeds 42 0 1 2 3
    python tests/torch_port_convergence.py --package torch --learner ppo
    python tests/torch_port_convergence.py --package torch --learner qrdqn
    python tests/torch_port_convergence.py --package torch --env pendulum --learner csac
    python tests/torch_port_convergence.py --package torch --env sparse_reach --learner her
    python tests/torch_port_convergence.py --package torch --env partial_cartpole \
        --learner lstm_dqn --seeds 7
    python tests/torch_port_convergence.py --package torch --learner cql
    python tests/torch_port_convergence.py --package torch --env offline --learner iql
    python tests/torch_port_convergence.py --package torch --env rc_pendulum --seeds 0 1 2
    python tests/torch_port_convergence.py --package torch --env frozen_lake --learner tabular_q
    python tests/torch_port_convergence.py --package torch --env mean_var_bandit \
        --learner qrdqn_mean_variance --seeds 0
    python tests/torch_port_convergence.py --package torch --env cb_suite --seeds 0 1 2
    python tests/torch_port_convergence.py --package torch --learner mesh_dqn --mesh 2
    python tests/torch_port_convergence.py --package jax --env learning_signal --seeds 0 1 2

`--package torch` runs the port on the CPU unless `--device cuda` is given.
Prints one JSON line per seed.
"""

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARTPOLE = dict(target_return=500.0, target_window=20)
# test_convergence.py's `_run_cartpole` defaults (:48-58), with its budget.
TD_DRIVER = dict(num_envs=16, max_steps=400_000, learn_every_k_steps=2, learning_starts=500)
# Per CartPole learner: its constructor arguments (None: DQN's; the TD
# learners' ε-greedy 0.05 is added in `run`), its buffer's rollout length
# (None: a 10000-row BasicReplayBuffer; "sarsa": a 10000-row
# SARSAReplayBuffer) and its driver arguments.
CARTPOLE_LEARNERS = {
    "dqn": (None, None, dict(TD_DRIVER, max_steps=250_000)),
    "dueling": (dict(training_rounds=4, batch_size=128), None, TD_DRIVER),
    "qrdqn": (dict(training_rounds=4, batch_size=128), None, TD_DRIVER),
    "sarsa": (dict(training_rounds=4, batch_size=128), "sarsa", TD_DRIVER),
    "double": (dict(training_rounds=4, batch_size=128), None, TD_DRIVER),
    "cql": (dict(is_conservative=True, conservative_alpha=1.0, training_rounds=4,
                 batch_size=128), None, TD_DRIVER),
    # The mesh anchor (test_convergence.py:289-316), meant for --mesh 2.
    "mesh_dqn": (dict(training_rounds=4, batch_size=128), None,
                 dict(TD_DRIVER, max_steps=250_000)),
    "sac": (dict(training_rounds=2, batch_size=100, entropy_coef=0.01, entropy_autotune=False,
                 actor_learning_rate=1e-3, critic_learning_rate=1e-3),
            None, dict(num_envs=16, max_steps=500_000, learn_every_k_steps=2,
                       learning_starts=500)),
    "ppo": (dict(training_rounds=20, batch_size=64, epsilon=0.1, actor_learning_rate=1e-4,
                 critic_learning_rate=1e-4),
            16, dict(num_envs=16, max_steps=400_000, learn_every_k_steps=16,
                     learning_starts=0)),
    "reinforce": (dict(actor_learning_rate=1e-3, critic_learning_rate=1e-3),
                  128, dict(num_envs=32, max_steps=3_000_000, learn_every_k_steps=128,
                            learning_starts=0)),
}
PENDULUM = dict(
    num_envs=16, learn_every_k_steps=1, learning_starts=1_000, target_return=-250.0,
    target_window=20,
)
# Per learner: its constructor arguments and its env-step budget.
PENDULUM_LEARNERS = {
    "csac": (dict(training_rounds=2, batch_size=100, entropy_coef=0.1,
                  actor_learning_rate=1e-3, critic_learning_rate=1e-3), 300_000),
    "ddpg": (dict(training_rounds=2, batch_size=100,
                  actor_learning_rate=1e-3, critic_learning_rate=1e-3), 200_000),
    "td3": (dict(training_rounds=2, batch_size=100,
                 actor_learning_rate=1e-3, critic_learning_rate=1e-3), 200_000),
}
# test_convergence.py:193-211: DQN with HER on the 8-direction sparse reach
# task, 150000 env steps, no early stop.
SPARSE_REACH = dict(length=50.0, num_actions=8, step_size=4.0, reward_distance=4.0, max_steps=40)
SPARSE_LEARNERS = {"her": 150_000}
# The history anchors: (summarizer arguments, replay capacity, env steps).
PARTIAL_LEARNERS = {
    "lstm_dqn": (dict(history_length=8, hidden_dim=64, num_layers=1), 50_000, 100_000),
    "transformer_dqn": (dict(history_length=8, dim=64, num_layers=1, num_heads=4), 50_048,
                        300_000),
}
# The offline anchors: test_convergence.py:222-263 ("iql": a continuous SAC
# behaviour agent trained to Pendulum -250, 50000 transitions collected from
# it without exploiting, IQL on 5000 batches of 256, the mean return of a
# greedy evaluation over 40000 env steps, which the reference holds above
# -600) and "offline_cql", chip_smoke.py's CartPole twin (the "dqn" learner
# above to CartPole 500, 16384 greedy transitions, CQL with the multi-head
# Q-network on 1000 batches of 128, evaluated over 16384 env steps; no
# reference anchor).
OFFLINE_LEARNERS = ("iql", "offline_cql")
# A diagnostic, not an anchor: RCCSAC (pearl_tpu/benchmarks/configs.py:
# 401-408, 527-537: constraint 0.2) on Pendulum with its torque cost at 16
# envs, a learn every step from the first, 1250 learns (chip_smoke.py's rc
# phase); prints lambda and the left side of its update, the cost critic's
# E[max(Q_c1, Q_c2)] * (1 - 0.5) at 4096 replay states under the policy's
# actions, which must pass the constraint for lambda to leave 0.
RC_LEARNERS = ("rccsac",)
# The remaining envs' anchors, by env: its learners and the seed the
# reference's test runs at.
ENV_ANCHORS = {
    "frozen_lake": (("dqn", "tabular_q"), {"dqn": 42, "tabular_q": 0}),
    "catcher": (("dqn",), {"dqn": 7}),
    "recsys": (("dqn",), {"dqn": 3}),
    "mean_var_bandit": (("qrdqn_risk_neutral", "qrdqn_mean_variance"),
                        {"qrdqn_risk_neutral": 0, "qrdqn_mean_variance": 0}),
}
LEARNER_NAMES = {
    "csac": "ContinuousSoftActorCritic", "ddpg": "DeepDeterministicPolicyGradient", "td3": "TD3",
    "sac": "SoftActorCritic", "ppo": "ProximalPolicyOptimization", "reinforce": "REINFORCE",
    "dueling": "DeepQLearning", "qrdqn": "QuantileRegressionDeepQLearning",
    "sarsa": "DeepSARSA", "double": "DoubleDQN", "cql": "DeepQLearning",
    "mesh_dqn": "DeepQLearning",
}
TD_LEARNERS = ("dueling", "qrdqn", "sarsa", "double", "cql", "mesh_dqn")


def _modules(package):
    """The package's modules this script uses, by the same names."""
    root = "pearl_tpu" if package == "jax" else "pearl_tpu_torch"
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        q_networks = mod("neural_networks.q_value_networks")
        buffers = mod("replay_buffers.replay_buffer")
        on_policy = mod("replay_buffers.on_policy")
        sarsa = mod("replay_buffers.sarsa")
        hindsight = mod("replay_buffers.hindsight")
        sparse = mod("envs.sparse_reward")
    else:
        import torch

        torch.set_num_threads(2)
        q_networks = mod("neural_networks")
        buffers = on_policy = sarsa = hindsight = mod("replay_buffers")
        sparse = mod("envs")
    return dict(
        agent=mod("agent"), envs=mod("envs"), q_networks=q_networks,
        exploration=mod("policy_learners.exploration_modules"),
        learners=mod("policy_learners.sequential_decision_making"),
        buffers=buffers, on_policy=on_policy, sarsa=sarsa, hindsight=hindsight, sparse=sparse,
        training=mod("training"), history=mod("history_summarization_modules"),
        offline=mod("training.offline"), collect=mod("training.collect"),
        offline_rl=mod("benchmarks.offline_rl" if package == "jax" else "benchmarks"),
    )


def run_rc(package, seed, device):
    """The RCCSAC diagnostic; returns lambda and the cost estimate."""
    m = _modules(package)
    safety = importlib.import_module(
        ("pearl_tpu" if package == "jax" else "pearl_tpu_torch") + ".safety_modules"
    )
    extra = {} if package == "jax" else {"device": device}
    agent = m["agent"].PearlAgent(
        policy_learner=m["learners"].ContinuousSoftActorCritic(training_rounds=1, batch_size=256),
        replay_buffer=m["buffers"].BasicReplayBuffer(capacity=50_000),
        safety_module=safety.RCSafetyModuleCostCriticContinuousAction(
            constraint_value=0.2, batch_size=256
        ),
        store_cost=True,
    )
    env = m["envs"].Pendulum(emit_torque_cost=True)
    t0 = time.perf_counter()
    res = m["training"].online_learning(
        agent, env, num_envs=16, max_steps=16 * 1_250, learn_every_k_steps=1, learning_starts=0,
        seed=seed, **extra,
    )
    seconds = time.perf_counter() - t0
    bound = agent.for_env(env)
    module, learner = bound.safety_module, bound.policy_learner
    astate = res.agent_state
    ls, ss = astate.learner, astate.safety
    if package == "jax":
        import jax
        import jax.numpy as jnp

        k_sample, k_act = jax.random.split(jax.random.PRNGKey(seed + 1))
        batch = bound.replay_buffer.sample(astate.replay, k_sample, 4096)
        subj = learner.history_summarizer.forward(ls.summarizer_params, batch.state)
        action = module._policy_action(learner, ls, subj, k_act)
        q1, q2 = module._critic().q_both(ss.critic_params, subj, action)
        cost_q = float(jnp.mean(jnp.maximum(q1, q2)))
        lam = float(ss.lagrangian)
    else:
        import torch

        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = bound.replay_buffer.sample(astate.replay, gen, 4096)
        with torch.no_grad():
            subj = learner.history_summarizer.forward(ls.summarizer_params, batch.state)
            action = module._policy_action(learner, ls, subj, gen, None)
            q1, q2 = module._critic().q_both(ss.critic_params, subj, action)
        cost_q = float(torch.maximum(q1, q2).mean())
        lam = float(ss.lagrangian)
    costs = np.asarray(res.episode_costs)
    return {
        "learns": 1_250, "lambda": lam,
        "cost_estimate_times_1_minus_gamma_c": cost_q * (1.0 - module.cost_discount_factor),
        "constraint": module.constraint_value, "episodes": int(len(costs)),
        "mean_episode_cost_last_16": float(costs[-16:].mean()) if len(costs) else None,
        "seconds": round(seconds, 1),
    }


def run_offline(package, learner_name, seed, device):
    """One offline anchor; returns its numbers. `seed` is the behaviour
    agent's; collection, offline training and evaluation keep the
    reference's seeds (7, 0 and 1)."""
    m = _modules(package)
    extra = {} if package == "jax" else {"device": device}
    t0 = time.perf_counter()
    if learner_name == "iql":
        env = m["envs"].Pendulum()
        kwargs, _ = PENDULUM_LEARNERS["csac"]
        behaviour = m["agent"].PearlAgent(
            policy_learner=m["learners"].ContinuousSoftActorCritic(**kwargs),
            replay_buffer=m["buffers"].BasicReplayBuffer(capacity=100_000),
        )
        res = m["training"].online_learning(
            behaviour, env, max_steps=100_000, seed=seed, **PENDULUM, **extra
        )
        collect = dict(num_transitions=50_000, exploit=False)
        learner = m["learners"].ImplicitQLearning()
        learn = dict(number_of_batches=5_000, batch_size=256, log_every=1_000)
        eval_steps = 40_000
    else:
        env = m["envs"].CartPole()
        res = run(package, "cartpole", "dqn", seed, device)
        # The agent `run` trained, whose learner state `res` holds.
        behaviour = m["agent"].PearlAgent(policy_learner=m["learners"].DeepQLearning(
            q_network=m["q_networks"].MultiHeadQValueNetwork(), training_rounds=4,
            batch_size=128, exploration=m["exploration"].EGreedyExploration(epsilon=0.05),
        ))
        collect = dict(num_transitions=16_384, exploit=True)
        learner = m["learners"].DeepQLearning(
            q_network=m["q_networks"].MultiHeadQValueNetwork(), is_conservative=True,
            conservative_alpha=1.0, batch_size=128,
        )
        learn = dict(number_of_batches=1_000, batch_size=128, log_every=100)
        eval_steps = 16_384
    behaviour_steps, t_behaviour = res.total_steps, time.perf_counter() - t0
    batch = m["collect"].collect_offline_data(
        behaviour, env, num_envs=16, learner_state=res.agent_state.learner, seed=7, **collect,
        **extra,
    )
    buffer, buf_state = m["offline_rl"].buffer_from_batch(batch)
    agent = m["agent"].PearlAgent(policy_learner=learner).for_env(env)
    obs_dim = env.observation_dim
    if package == "jax":
        import jax

        astate = agent.init(jax.random.PRNGKey(0), obs_dim, 1, np.zeros((1, obs_dim), np.float32))
    else:
        import torch

        astate = agent.init(0, obs_dim, 1, torch.zeros(1, obs_dim), device=device)
    t1 = time.perf_counter()
    astate = m["offline"].offline_learning(agent, astate, buffer, buf_state, seed=0, **learn)
    t_learn = time.perf_counter() - t1
    returns = m["offline"].offline_evaluation(
        agent, astate, env, num_envs=16, max_steps=eval_steps, **extra
    )
    return {
        "behaviour_reached_target": bool(res.reached_target),
        "behaviour_env_steps": int(behaviour_steps), "behaviour_seconds": round(t_behaviour, 1),
        "offline_learn_seconds": round(t_learn, 1), "eval_episodes": int(len(returns)),
        "eval_mean_return": float(np.mean(returns)),
        "anchor_met": bool(np.mean(returns) > -600.0) if learner_name == "iql" else None,
        "seconds": round(time.perf_counter() - t0, 1),
    }


def _greedy_frozen_lake_return(package, q_table):
    """The greedy table's return from FrozenLake's start over 20 steps
    (test_misc_components.py:63-75); the lake is not slippery, so the run is
    the same in both packages."""
    m = _modules(package)
    env = m["envs"].FrozenLake(slippery=False)
    q = np.asarray(q_table.cpu() if package == "torch" else q_table)
    if package == "jax":
        import jax
        import jax.numpy as jnp

        state, obs = env.reset(jax.random.PRNGKey(0))
        step = lambda st, a: env.step(st, jnp.array([a], jnp.float32), jax.random.PRNGKey(0))  # noqa: E731
        cell = lambda o: int(np.argmax(np.asarray(o)))  # noqa: E731
    else:
        import torch

        state, obs = env.reset(1, torch.Generator().manual_seed(0), "cpu")
        step = lambda st, a: env.step(st, torch.tensor([[float(a)]]))  # noqa: E731
        cell = lambda o: int(np.argmax(np.asarray(o)[0]))  # noqa: E731
    total = 0.0
    for _ in range(20):
        state, result = step(state, int(np.argmax(q[cell(obs)])))
        obs = result.observation
        total += float(np.asarray(result.reward).reshape(-1)[0])
        if bool(np.asarray(result.terminated | result.truncated).reshape(-1)[0]):
            break
    return total


def _greedy_bandit_choices(package, agent, env, learner_state, device):
    """The share of 16 greedy acts on the bandit's observation that pick
    arm 1 (test_risk_sensitive_and_transformer.py:48-53)."""
    learner = agent.for_env(env).policy_learner
    if package == "jax":
        import jax
        import jax.numpy as jnp

        _, choice = learner.act(learner_state, jnp.zeros((16, 1)), None, jax.random.PRNGKey(0),
                                exploit=True)
    else:
        import torch

        _, choice = learner.act(learner_state, torch.zeros((16, 1), device=device), None,
                                torch.Generator(device=device).manual_seed(0), exploit=True)
    return float(np.mean(np.asarray(choice.index.cpu() if package == "torch" else choice.index)
                         == 1))


def run_env_anchor(package, env_name, learner_name, seed, device):
    """One anchor of ENV_ANCHORS at `seed`; returns its numbers and whether
    the reference's gate was met."""
    m = _modules(package)
    extra = {} if package == "jax" else {"device": device}
    agent_mod, learners, expl, buffers = m["agent"], m["learners"], m["exploration"], m["buffers"]
    t0 = time.perf_counter()
    if env_name == "frozen_lake" and learner_name == "dqn":
        agent = agent_mod.PearlAgent(
            policy_learner=learners.DeepQLearning(
                training_rounds=4, batch_size=64, exploration=expl.EGreedyExploration(epsilon=0.05)),
            replay_buffer=buffers.BasicReplayBuffer(capacity=10_000),
        )
        res = m["training"].online_learning(
            agent, m["envs"].FrozenLake(one_hot_obs=True, slippery=False), num_envs=16,
            max_steps=300_000, learn_every_k_steps=2, learning_starts=500, seed=seed,
            target_return=1.0, target_window=5, **extra)
        out = {"reached_target": bool(res.reached_target), "env_steps": int(res.total_steps),
               "anchor_met": bool(res.reached_target)}
    elif env_name == "frozen_lake":
        tabular = importlib.import_module(learners.__name__ + ".tabular_q")
        agent = agent_mod.PearlAgent(
            policy_learner=tabular.TabularQLearning(
                learning_rate=0.5, exploration=expl.EGreedyExploration(epsilon=0.3)),
            replay_buffer=buffers.BasicReplayBuffer(capacity=8),
        )
        res = m["training"].online_learning(
            agent, m["envs"].FrozenLake(slippery=False), num_envs=8, max_steps=8 * 2000,
            learn_every_k_steps=1, seed=seed, **extra)
        total = _greedy_frozen_lake_return(package, res.agent_state.learner.q_table)
        out = {"greedy_return": total, "anchor_met": total == 1.0}
    elif env_name == "catcher":
        agent = agent_mod.PearlAgent(
            policy_learner=learners.DeepQLearning(
                training_rounds=2, batch_size=128, exploration=expl.EGreedyExploration(
                    start_epsilon=0.5, end_epsilon=0.05, warmup_steps=30_000)),
            replay_buffer=buffers.BasicReplayBuffer(capacity=50_000),
        )
        res = m["training"].online_learning(
            agent, m["envs"].Catcher(), num_envs=32, max_steps=120_000, learn_every_k_steps=4,
            learning_starts=2_000, seed=seed, **extra)
        r = np.asarray(res.episode_returns)
        n = max(len(r) // 10, 20)
        first, last = float(r[:n].mean()), float(r[-n:].mean())
        out = {"mean_first_tenth": first, "mean_last_tenth": last,
               "anchor_met": last > first + 1.0}
    elif env_name == "recsys":
        reps = importlib.import_module(
            ("pearl_tpu" if package == "jax" else "pearl_tpu_torch")
            + ".action_representation_modules")
        agent = agent_mod.PearlAgent(
            policy_learner=learners.DeepQLearning(
                training_rounds=2, batch_size=128, exploration=expl.EGreedyExploration(
                    start_epsilon=0.3, end_epsilon=0.05, warmup_steps=10_000),
                action_representation=reps.IdentityActionRepresentation()),
            replay_buffer=buffers.BasicReplayBuffer(capacity=20_000),
            track_available_masks=True,
        )
        res = m["training"].online_learning(
            agent, recsys_env(package, device), num_envs=32, max_steps=40_000,
            learn_every_k_steps=4, learning_starts=1_000, seed=seed, **extra)
        last = float(np.asarray(res.episode_returns)[-50:].mean())
        out = {"mean_last_50": last, "anchor_met": last > 10.5}
    else:
        safety = importlib.import_module(
            ("pearl_tpu" if package == "jax" else "pearl_tpu_torch") + ".safety_modules")
        module = (safety.RiskNeutralSafetyModule() if learner_name == "qrdqn_risk_neutral" else
                  safety.QuantileNetworkMeanVarianceSafetyModule(variance_weighting_coefficient=0.5))
        agent = agent_mod.PearlAgent(
            policy_learner=learners.QuantileRegressionDeepQLearning(
                training_rounds=2, batch_size=64, exploration=expl.EGreedyExploration(epsilon=0.3),
                discount_factor=0.0),
            replay_buffer=buffers.BasicReplayBuffer(capacity=2048),
            safety_module=module,
        )
        env = m["envs"].MeanVarBanditEnvironment()
        res = m["training"].online_learning(
            agent, env, num_envs=8, max_steps=3_000 * 8, learn_every_k_steps=2,
            learning_starts=256, seed=seed, **extra)
        risky = _greedy_bandit_choices(package, agent, env, res.agent_state.learner, device)
        out = {"greedy_share_of_risky_arm": risky,
               "anchor_met": risky > 0.9 if learner_name == "qrdqn_risk_neutral"
               else 1.0 - risky > 0.9}
    return {**out, "seconds": round(time.perf_counter() - t0, 1)}


RECSYS_CATALOG = os.path.join(REPO, "pearl_tpu_torch", "envs", "data", "recsys_catalog.npz")


def export_recsys_catalog(path=RECSYS_CATALOG):
    """Write the JAX env's catalog and user model (`recsys_env("jax")`) and
    its scalar fields to `path`: the file chip_smoke.py's recommender phase
    loads, since it runs without JAX. Run:

        python -c "from tests.torch_port_convergence import export_recsys_catalog as e; e()"
    """
    jenv = recsys_env("jax", None)
    np.savez(path, **{k: np.asarray(getattr(jenv, k)) for k in (
        "items", "w1", "b1", "w2", "slate_size", "episode_length", "history_length",
        "logit_scale")})


def recsys_env(package, device):
    """tests/test_recsys.py:18-21's env: the JAX package's catalog and user
    model from PRNGKey(7), carried to the port with
    `recommender_env_from_jax` so both packages learn on one model."""
    import jax

    from pearl_tpu.envs.recsys import RecommenderEnvironment

    jax.config.update("jax_platforms", "cpu")

    jenv = RecommenderEnvironment.create(jax.random.PRNGKey(7), num_items=50, item_dim=8,
                                         slate_size=2)
    if package == "jax":
        return jenv
    from pearl_tpu_torch.utils.jax_params import recommender_env_from_jax

    return recommender_env_from_jax(jenv, device)


def run(package, env_name, learner_name, seed, device, mesh=None):
    m = _modules(package)
    extra = {} if package == "jax" else {"device": device}
    if mesh is not None:
        extra = {"mesh": mesh}  # the port's mesh carries its device
    if env_name == "cartpole":
        kwargs, rollout, driver = CARTPOLE_LEARNERS[learner_name]
        if kwargs is None:
            learner = m["learners"].DeepQLearning(
                q_network=m["q_networks"].MultiHeadQValueNetwork(), training_rounds=4,
                batch_size=128, exploration=m["exploration"].EGreedyExploration(epsilon=0.05),
            )
        elif learner_name in TD_LEARNERS:
            extra_kw = {"exploration": m["exploration"].EGreedyExploration(epsilon=0.05)}
            if learner_name == "dueling":
                extra_kw["q_network"] = m["q_networks"].DuelingQValueNetwork()
            learner = getattr(m["learners"], LEARNER_NAMES[learner_name])(**kwargs, **extra_kw)
        else:
            learner = getattr(m["learners"], LEARNER_NAMES[learner_name])(**kwargs)
        if rollout is None:
            buffer = m["buffers"].BasicReplayBuffer(capacity=10_000)
        elif rollout == "sarsa":
            buffer = m["sarsa"].SARSAReplayBuffer(capacity=10_000, num_envs=driver["num_envs"])
        else:
            num_envs = driver["num_envs"]
            buffer = m["on_policy"].OnPolicyReplayBuffer(
                capacity=rollout * num_envs, num_envs=num_envs
            )
        agent = m["agent"].PearlAgent(policy_learner=learner, replay_buffer=buffer)
        return m["training"].online_learning(
            agent, m["envs"].CartPole(), seed=seed, **CARTPOLE, **driver, **extra
        )
    if env_name == "sparse_reach":
        num_envs = 16
        agent = m["agent"].PearlAgent(
            policy_learner=m["learners"].DeepQLearning(
                training_rounds=4, batch_size=128,
                exploration=m["exploration"].EGreedyExploration(epsilon=0.1),
            ),
            replay_buffer=m["hindsight"].HindsightExperienceReplayBuffer(
                capacity=100_000, num_envs=num_envs, max_episode_len=40, goal_dim=2
            ),
        )
        return m["training"].online_learning(
            agent, m["sparse"].DiscreteSparseRewardEnvironment(**SPARSE_REACH),
            num_envs=num_envs, max_steps=SPARSE_LEARNERS[learner_name], learn_every_k_steps=2,
            learning_starts=1_000, seed=seed, **extra,
        )
    if env_name == "partial_cartpole":
        summ_kwargs, capacity, budget = PARTIAL_LEARNERS[learner_name]
        summ_cls = (
            m["history"].LSTMHistorySummarization
            if learner_name == "lstm_dqn"
            else m["history"].TransformerHistorySummarization
        )
        agent = m["agent"].PearlAgent(
            policy_learner=m["learners"].DeepQLearning(
                training_rounds=2, batch_size=128,
                exploration=m["exploration"].EGreedyExploration(
                    start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000
                ),
                history_summarizer=summ_cls(**summ_kwargs),
            ),
            replay_buffer=m["buffers"].BasicReplayBuffer(capacity=capacity),
        )
        env = m["envs"].PartialObservabilityWrapper(
            env=m["envs"].CartPole(), observed_indices=(0, 2)
        )
        return m["training"].online_learning(
            agent, env, num_envs=32, max_steps=budget, learn_every_k_steps=4,
            learning_starts=2_000, seed=seed, **extra,
        )
    kwargs, budget = PENDULUM_LEARNERS[learner_name]
    learner = getattr(m["learners"], LEARNER_NAMES[learner_name])(**kwargs)
    agent = m["agent"].PearlAgent(
        policy_learner=learner, replay_buffer=m["buffers"].BasicReplayBuffer(capacity=100_000)
    )
    return m["training"].online_learning(
        agent, m["envs"].Pendulum(), max_steps=budget, seed=seed, **PENDULUM, **extra
    )


# The CB suite runs its four methods together (benchmarks/cb.py's CB_METHODS).
CB_LEARNERS = ("cb_methods",)


def run_cb_suite(package, seed, device):
    """Every CB method on every dataset at the reference's T = 5000 over 10
    envs: {dataset: {method: final_avg_regret}} and the seconds of each
    dataset."""
    root = "pearl_tpu" if package == "jax" else "pearl_tpu_torch"
    _modules(package)  # JAX on the CPU, the port's thread count
    cb = importlib.import_module(f"{root}.benchmarks.cb")
    kwargs = {} if package == "jax" else {"device": device}
    regrets, seconds = {}, {}
    for ds in cb.CB_DATASETS:
        t0 = time.perf_counter()
        res = cb.run_cb_benchmark_suite(datasets=(ds,), T=5_000, num_envs=10, seed=seed,
                                        **kwargs)
        seconds[ds] = round(time.perf_counter() - t0, 1)
        regrets[ds] = {m: round(res[ds][m]["final_avg_regret"], 4) for m in cb.CB_METHODS}
    return {"final_avg_regret": regrets, "seconds": seconds}


LEARNING_SIGNAL_LEARNERS = ("registry",)


def _jax_frozen_target_losses(name, method, seed):
    """The JAX side of `run_learning_signal`: the row logic of
    tests/test_learning_signal_matrix.py:50-118 (fill seed `seed`, learn key
    `seed + 1`), returning (metric, per-learn values)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pearl_tpu.replay_buffers.on_policy import OnPolicyReplayBuffer
    from pearl_tpu.training import online_learning
    from test_all_methods_matrix import env_for_method

    agent = method.make_agent(4)
    env = env_for_method(method, agent)
    rollout = method.on_policy_rollout
    if rollout is not None:
        rollout = 16
        agent = dataclasses.replace(
            agent, replay_buffer=OnPolicyReplayBuffer(capacity=rollout * 4, num_envs=4))
    res = online_learning(agent, env, num_envs=4, max_steps=(rollout or 32) * 4,
                          learn_every_k_steps=rollout or 32, learn=False, seed=seed)
    storage = res.agent_state.replay.storage
    if isinstance(storage, dict):
        rest = storage["rest"].replace(terminated=jnp.ones_like(storage["rest"].terminated))
        if float(jnp.abs(rest.reward).mean()) < 0.05:
            n = rest.reward.shape[0]
            rest = rest.replace(reward=1.0 + storage["frame_s"].reshape(n, -1).mean(axis=1))
        storage = {**storage, "rest": rest}
    else:
        storage = storage.replace(terminated=jnp.ones_like(storage.terminated))
        if float(jnp.abs(storage.reward).mean()) < 0.05:
            n = storage.reward.shape[0]
            storage = storage.replace(reward=1.0 + storage.state.reshape(n, -1).mean(axis=1))
    buffer_state = res.agent_state.replay.replace(storage=storage)
    learner, buffer = agent.for_env(env).policy_learner, agent.replay_buffer
    n_learns = 90 if method.env_family.startswith("visual") else 60

    @jax.jit
    def learns(ls, bs, key):
        def one(carry, k):
            ls, bs, metrics = learner.learn(carry[0], buffer, carry[1], k)
            return (ls, bs), metrics

        return jax.lax.scan(one, (ls, bs), jax.random.split(key, n_learns))[1]

    metrics = learns(res.agent_state.learner, buffer_state, jax.random.PRNGKey(seed + 1))
    metric = next(k for k in ("loss", "critic_loss", "value_loss") if k in metrics)
    return metric, np.asarray(metrics[metric])


def run_learning_signal(package, seed, device):
    """Every registry row's learning signal on frozen targets (the check of
    tests/test_learning_signal_matrix.py and tests/test_torch_learning_signal.py):
    {row: [metric, early, late, late / early, threshold]}, the rows'
    thresholds those of `pearl_tpu_torch/benchmarks/guarantees.py`, and the
    rows that miss one. The reference's seeds are fill seed 0, learn key 1."""
    _modules(package)  # JAX on the CPU, the port's thread count
    from pearl_tpu_torch.benchmarks.guarantees import (
        RATIO_DEFAULT, RATIO_OVERRIDES, SignalReport, frozen_target_signal,
    )

    root = "pearl_tpu" if package == "jax" else "pearl_tpu_torch"
    methods = importlib.import_module(f"{root}.benchmarks.configs").METHODS
    rows, misses = {}, []
    for name, method in sorted(methods.items()):
        if package == "torch":
            r = frozen_target_signal(name, method, seed=seed, learn_seed=seed + 1, device=device)
        else:
            metric, values = _jax_frozen_target_losses(name, method, seed)
            r = SignalReport(name=name, metric=metric, early=float(values[:3].mean()),
                             late=float(values[-3:].mean()),
                             threshold=RATIO_OVERRIDES.get(name, RATIO_DEFAULT),
                             finite=bool(np.isfinite(values).all()), learns=len(values))
        rows[name] = [r.metric, round(r.early, 6), round(r.late, 6), round(r.ratio, 6),
                      r.threshold]
        if r.failures():
            misses.append(name)
    return {"rows": rows, "misses": misses}


def _mesh(package, n):
    """A mesh of `n` for the JAX package (its virtual CPU devices)."""
    if n <= 1 or package != "jax":
        return None
    from pearl_tpu.parallel import make_mesh

    return make_mesh(n)


def replica_spread(package, learner_state, mesh_size):
    """The largest difference of a learner leaf between two replicas: over the
    JAX state's stacked device axis, or over the port's ranks (each rank's
    float64 sum of |leaf| over its leaves, gathered)."""
    if package == "jax":
        import jax

        return max(float(np.max(np.abs(np.asarray(x) - np.asarray(x)[0])))
                   for x in jax.tree.leaves(learner_state.params))
    import dataclasses

    import torch

    from pearl_tpu_torch.utils.collectives import gather_blocks
    from pearl_tpu_torch.utils.pytree import named_leaves

    learner_state = dataclasses.replace(learner_state, explore_state=None)
    leaves = [v.double().abs().sum() for _, v in named_leaves(learner_state)
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    axis = _PORT_MESH["mesh"].axis("data")
    sums = gather_blocks(torch.stack(leaves).to(axis.device), axis)
    return float((sums - sums[0]).abs().max())


_PORT_MESH = {}


def _report(args, seed, res, seconds, mesh_size):
    """The JSON line of one run of `run`."""
    extra = {}
    if args.env == "sparse_reach":
        # Reached the goal before truncation (test_convergence.py:216).
        success = np.asarray(res.episode_returns) > -40.0 + 0.5
        extra = {"success_last_200": float(success[-200:].mean()),
                 "success_first_200": float(success[:200].mean())}
    if args.env == "partial_cartpole":
        # The mean return of the last and the first tenth of the episodes
        # (at least 20), as the reference's tests take it.
        r = np.asarray(res.episode_returns)
        n = max(len(r) // 10, 20)
        extra = {"mean_last_tenth": float(r[-n:].mean()),
                 "mean_first_tenth": float(r[:n].mean()),
                 "anchor_met": bool(r[-n:].mean() > 100.0)}
    if mesh_size > 1:
        extra = {"mesh": mesh_size,
                 "replica_spread": replica_spread(args.package, res.agent_state.learner,
                                                  mesh_size)}
    return {
        "package": args.package, "env": args.env,
        "learner": args.learner, "seed": seed,
        "reached_target": bool(res.reached_target), "env_steps": int(res.total_steps),
        "episodes": int(len(res.episode_returns)),
        "seconds": round(seconds, 1), **extra,
    }


def _port_mesh_rank(rank, args, seed, url):
    """One rank of `--mesh N` for the port: joins the gloo world, runs, and
    rank 0 prints the line."""
    sys.path.insert(0, REPO)
    from pearl_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(url, args.mesh, rank, backend="gloo")
    mesh = _PORT_MESH["mesh"] = make_mesh(args.mesh, device=args.device, backend="gloo")
    t0 = time.perf_counter()
    res = run("torch", args.env, args.learner, seed, args.device, mesh=mesh)
    line = _report(args, seed, res, time.perf_counter() - t0, args.mesh)
    if rank == 0:
        print(json.dumps(line), flush=True)


def run_port_mesh(args, seed):
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        mp.spawn(_port_mesh_rank, args=(args, seed, f"file://{directory}/rendezvous"),
                 nprocs=args.mesh)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--env", choices=("cartpole", "pendulum", "sparse_reach",
                                          "partial_cartpole", "offline", "rc_pendulum",
                                          "cb_suite", "learning_signal")
                        + tuple(ENV_ANCHORS), default="cartpole")
    env_learners = tuple(x for names, _ in ENV_ANCHORS.values() for x in names)
    parser.add_argument("--learner", choices=tuple(dict.fromkeys(
                            tuple(CARTPOLE_LEARNERS) + tuple(PENDULUM_LEARNERS)
                            + tuple(SPARSE_LEARNERS) + tuple(PARTIAL_LEARNERS) + OFFLINE_LEARNERS
                            + RC_LEARNERS + CB_LEARNERS + LEARNING_SIGNAL_LEARNERS
                            + env_learners)),
                        help="dqn, dueling, qrdqn, sarsa, double, cql, sac, ppo or reinforce "
                        "on CartPole (default dqn); csac, "
                        "ddpg or td3 on Pendulum (default csac); her on sparse_reach; "
                        "lstm_dqn or transformer_dqn on partial_cartpole; iql or offline_cql "
                        "on offline; rccsac on rc_pendulum; dqn or tabular_q on frozen_lake; "
                        "dqn on catcher and recsys; qrdqn_risk_neutral or qrdqn_mean_variance "
                        "on mean_var_bandit; cb_methods (all four) on cb_suite; registry "
                        "(every METHODS row) on learning_signal")
    parser.add_argument("--seeds", type=int, nargs="+", default=[42])
    parser.add_argument("--device", default="cpu", help="torch device (port only)")
    parser.add_argument("--mesh", type=int, default=1,
                        help="data-parallel ranks (CartPole and Pendulum learners)")
    args = parser.parse_args()
    learners = {"cartpole": CARTPOLE_LEARNERS, "pendulum": PENDULUM_LEARNERS,
                "sparse_reach": SPARSE_LEARNERS, "partial_cartpole": PARTIAL_LEARNERS,
                "offline": OFFLINE_LEARNERS, "rc_pendulum": RC_LEARNERS,
                "cb_suite": CB_LEARNERS, "learning_signal": LEARNING_SIGNAL_LEARNERS,
                **{name: names for name, (names, _) in ENV_ANCHORS.items()}}[args.env]
    if args.learner is None:
        args.learner = next(iter(learners))
    if args.learner not in learners:
        parser.error(f"--learner {args.learner} does not run on --env {args.env}")
    if args.mesh > 1:
        if args.env not in ("cartpole", "pendulum"):
            parser.error("--mesh runs the CartPole and Pendulum learners")
        if args.package == "jax":  # before JAX starts: N virtual CPU devices
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       f" --xla_force_host_platform_device_count={args.mesh}")
    sys.path.insert(0, REPO)
    for seed in args.seeds:
        if args.mesh > 1 and args.package == "torch":
            run_port_mesh(args, seed)
            continue
        if args.env in ENV_ANCHORS:
            numbers = run_env_anchor(args.package, args.env, args.learner, seed, args.device)
            print(json.dumps({"package": args.package, "env": args.env, "learner": args.learner,
                              "seed": seed, "reference_seed": ENV_ANCHORS[args.env][1][
                                  args.learner], **numbers}), flush=True)
            continue
        if args.env in ("offline", "rc_pendulum", "cb_suite", "learning_signal"):
            numbers = {"offline": lambda: run_offline(args.package, args.learner, seed,
                                                      args.device),
                       "rc_pendulum": lambda: run_rc(args.package, seed, args.device),
                       "cb_suite": lambda: run_cb_suite(args.package, seed, args.device),
                       "learning_signal": lambda: run_learning_signal(args.package, seed,
                                                                      args.device),
                       }[args.env]()
            print(json.dumps({"package": args.package, "env": args.env,
                              "learner": args.learner, "seed": seed, **numbers}), flush=True)
            continue
        t0 = time.perf_counter()
        if args.package == "jax":
            _modules("jax")  # JAX on the CPU before the mesh takes its devices
        res = run(args.package, args.env, args.learner, seed, args.device,
                  mesh=_mesh(args.package, args.mesh))
        print(json.dumps(_report(args, seed, res, time.perf_counter() - t0, args.mesh)),
              flush=True)


if __name__ == "__main__":
    main()
