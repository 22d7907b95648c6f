"""Atari DQN through the host loop, on the port (the twin of
examples/atari_dqn.py; reference: the Atari branch of
scripts/benchmark_config.py + user_envs/wrappers/atari_wrappers.py).

Atari emulation is host-side by nature; the preprocessing stack
(NoopReset -> MaxAndSkip -> EpisodicLife -> FireReset) wraps a Gymnasium ALE
env, the `GymEnvironment` adapter bridges it to the functional API, and the
CNN Q-network trains through `training.agent_online_learning_host`, its
act, observe and learn on the card. `main` needs `gymnasium`, `ale_py` and
the Atari ROMs, which are imported only there: `make_agent` builds the
agent without them.

Run from the repository's root:
    python -m examples_torch.atari_dqn [PongNoFrameskip-v4]
"""

import argparse

import numpy as np

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
from pearl_tpu_torch.replay_buffers import BasicReplayBuffer
from pearl_tpu_torch.training import agent_online_learning_host


def make_agent() -> PearlAgent:
    """The reference's Atari DQN: the (32, 64, 64) CNN over 84x84x4 frames,
    batch 32, a bfloat16 replay of 100000 rows."""
    return PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(
                input_shape=(84, 84, 4),
                out_channels=(32, 64, 64),
                kernel_sizes=(8, 4, 3),
                strides=(4, 2, 1),
                paddings=(0, 0, 0),
                hidden_dims=(512,),
            ),
            training_rounds=1,
            batch_size=32,
            exploration=EGreedyExploration(
                start_epsilon=1.0, end_epsilon=0.05, warmup_steps=100_000
            ),
        ),
        replay_buffer=BasicReplayBuffer(capacity=100_000, bf16_storage=True),
    )


def make_env(name: str):
    """The reference's exact stack: Noop -> MaxAndSkip -> EpisodicLife ->
    Fire -> Resize -> Grayscale -> FrameStack(4), then transposed
    channels-last for the CNN, behind the `GymEnvironment` adapter."""
    import gymnasium

    from pearl_tpu_torch.envs.atari import wrap_atari
    from pearl_tpu_torch.envs.gym_adapter import GymEnvironment

    env = wrap_atari(gymnasium.make(name))
    env = gymnasium.wrappers.ResizeObservation(env, (84, 84))
    env = gymnasium.wrappers.GrayscaleObservation(env)
    env = gymnasium.wrappers.FrameStackObservation(env, 4)
    env = gymnasium.wrappers.TransformObservation(
        env,
        lambda o: np.transpose(np.asarray(o), (1, 2, 0)),
        gymnasium.spaces.Box(0, 255, (84, 84, 4), np.uint8),
    )
    return GymEnvironment(env)


def main(name="PongNoFrameskip-v4", device=None):
    returns = agent_online_learning_host(
        make_agent(), make_env(name), max_steps=1_000_000, learn_every_k_steps=4,
        learning_starts=10_000, seed=0, verbose=True, device=device,
    )
    print(f"episodes={len(returns)} last20={np.mean(returns[-20:]):.1f}")
    return returns


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("name", nargs="?", default="PongNoFrameskip-v4")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    main(**vars(p.parse_args()))
