"""Env steps each package needs to reach its target with the configurations
of tests/integration/test_convergence.py: CartPole 500 with the multi-head
Q-network (:48-79, the learning phase of chip_smoke.py), with Dueling DQN,
QR-DQN or deep SARSA (:86-110), or with discrete SAC, PPO or REINFORCE
(:124-158), and Pendulum -250 with continuous SAC, DDPG or TD3 (:62-71,
:161-187). Not collected by pytest; run it:

    python tests/torch_port_convergence.py --package jax --seeds 42
    python tests/torch_port_convergence.py --package torch --seeds 42 0 1 2 3
    python tests/torch_port_convergence.py --package torch --learner ppo
    python tests/torch_port_convergence.py --package torch --learner qrdqn
    python tests/torch_port_convergence.py --package torch --env pendulum --learner csac

`--package torch` runs the port on the CPU unless `--device cuda` is given.
Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

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
LEARNER_NAMES = {
    "csac": "ContinuousSoftActorCritic", "ddpg": "DeepDeterministicPolicyGradient", "td3": "TD3",
    "sac": "SoftActorCritic", "ppo": "ProximalPolicyOptimization", "reinforce": "REINFORCE",
    "dueling": "DeepQLearning", "qrdqn": "QuantileRegressionDeepQLearning",
    "sarsa": "DeepSARSA",
}
TD_LEARNERS = ("dueling", "qrdqn", "sarsa")


def _modules(package):
    """The package's modules this script uses, by the same names."""
    import importlib

    root = "pearl_tpu" if package == "jax" else "pearl_tpu_torch"
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        q_networks = mod("neural_networks.q_value_networks")
        buffers = mod("replay_buffers.replay_buffer")
        on_policy = mod("replay_buffers.on_policy")
        sarsa = mod("replay_buffers.sarsa")
    else:
        import torch

        torch.set_num_threads(2)
        q_networks = mod("neural_networks")
        buffers = on_policy = sarsa = mod("replay_buffers")
    return dict(
        agent=mod("agent"), envs=mod("envs"), q_networks=q_networks,
        exploration=mod("policy_learners.exploration_modules"),
        learners=mod("policy_learners.sequential_decision_making"),
        buffers=buffers, on_policy=on_policy, sarsa=sarsa, training=mod("training"),
    )


def run(package, env_name, learner_name, seed, device):
    m = _modules(package)
    extra = {} if package == "jax" else {"device": device}
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
    kwargs, budget = PENDULUM_LEARNERS[learner_name]
    learner = getattr(m["learners"], LEARNER_NAMES[learner_name])(**kwargs)
    agent = m["agent"].PearlAgent(
        policy_learner=learner, replay_buffer=m["buffers"].BasicReplayBuffer(capacity=100_000)
    )
    return m["training"].online_learning(
        agent, m["envs"].Pendulum(), max_steps=budget, seed=seed, **PENDULUM, **extra
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--env", choices=("cartpole", "pendulum"), default="cartpole")
    parser.add_argument("--learner", choices=tuple(CARTPOLE_LEARNERS) + tuple(PENDULUM_LEARNERS),
                        help="dqn, dueling, qrdqn, sarsa, sac, ppo or reinforce on CartPole "
                        "(default dqn); csac, "
                        "ddpg or td3 on Pendulum (default csac)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[42])
    parser.add_argument("--device", default="cpu", help="torch device (port only)")
    args = parser.parse_args()
    learners = CARTPOLE_LEARNERS if args.env == "cartpole" else PENDULUM_LEARNERS
    if args.learner is None:
        args.learner = next(iter(learners))
    if args.learner not in learners:
        parser.error(f"--learner {args.learner} does not run on --env {args.env}")
    sys.path.insert(0, REPO)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run(args.package, args.env, args.learner, seed, args.device)
        print(json.dumps({
            "package": args.package, "env": args.env,
            "learner": args.learner, "seed": seed,
            "reached_target": bool(res.reached_target), "env_steps": int(res.total_steps),
            "episodes": int(len(res.episode_returns)),
            "seconds": round(time.perf_counter() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
