"""Benchmark method registry (port of `pearl_tpu/benchmarks/configs.py`).

The same rows under the same names, each building the port's counterpart of
the reference's composition: learner, network, exploration, buffer,
capacity, batch size, rounds, `learn_every_k_steps`, `learning_starts`,
rollout and env family. Each `Method` builds its agent for a number of envs:
DQN / DoubleDQN / SARSA / DuelingDQN / QRDQN (and its variance-coefficient
risk rows) / BootstrappedDQN (and its one-member row) / CQL / PPO / REINFORCE
/ SAC / ContinuousSAC / DDPG / TD3 / TD3BC / IQL (discrete and continuous),
with LSTM-history, dynamic-action, CNN and reward-constrained (RCPO) rows,
and the experiment presets that group them by env."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from pearl_tpu_torch.agent import PearlAgent
from pearl_tpu_torch.history_summarization_modules import LSTMHistorySummarization
from pearl_tpu_torch.neural_networks.q_value_networks import (
    DuelingQValueNetwork,
    EnsembleQValueNetwork,
)
from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
from pearl_tpu_torch.policy_learners.sequential_decision_making import (
    BootstrappedDQN,
    ContinuousSoftActorCritic,
    DeepDeterministicPolicyGradient,
    DeepQLearning,
    DeepSARSA,
    DoubleDQN,
    ImplicitQLearning,
    ProximalPolicyOptimization,
    QuantileRegressionDeepQLearning,
    REINFORCE,
    SoftActorCritic,
    TD3,
)
from pearl_tpu_torch.replay_buffers.bootstrap import BootstrapReplayBuffer
from pearl_tpu_torch.replay_buffers.on_policy import OnPolicyReplayBuffer
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.replay_buffers.sarsa import SARSAReplayBuffer
from pearl_tpu_torch.replay_buffers.visual import VisualReplayBuffer


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    make_agent: Callable[[int], PearlAgent]  # num_envs -> agent
    learn_every_k_steps: int = 1
    learning_starts: int = 1_000
    continuous: bool = False
    on_policy_rollout: Optional[int] = None  # rollout steps for on-policy methods
    env_family: str = "classic"  # classic | continuous | visual


_EPS_SCHED = EGreedyExploration(start_epsilon=0.5, end_epsilon=0.05, warmup_steps=20_000)
_CAP = 50_000


def _off_policy(learner_fn, **kw):
    def make(num_envs: int) -> PearlAgent:
        return PearlAgent(
            policy_learner=learner_fn(),
            replay_buffer=kw.get("buffer_fn", lambda n: BasicReplayBuffer(capacity=_CAP))(
                num_envs
            ),
        )

    return make


def _on_policy(learner_fn, rollout: int):
    def make(num_envs: int) -> PearlAgent:
        return PearlAgent(
            policy_learner=learner_fn(),
            replay_buffer=OnPolicyReplayBuffer(
                capacity=rollout * num_envs, num_envs=num_envs
            ),
        )

    return make


METHODS = {
    "DQN": Method(
        "DQN",
        _off_policy(lambda: DeepQLearning(training_rounds=2, batch_size=128,
                                          exploration=_EPS_SCHED)),
        learn_every_k_steps=4,
    ),
    "DoubleDQN": Method(
        "DoubleDQN",
        _off_policy(lambda: DoubleDQN(training_rounds=2, batch_size=128,
                                      exploration=_EPS_SCHED)),
        learn_every_k_steps=4,
    ),
    "SARSA": Method(
        "SARSA",
        _off_policy(
            lambda: DeepSARSA(training_rounds=2, batch_size=128, exploration=_EPS_SCHED),
            buffer_fn=lambda n: SARSAReplayBuffer(capacity=_CAP, num_envs=n),
        ),
        learn_every_k_steps=4,
    ),
    "MultiHeadDQN": Method(
        "MultiHeadDQN",
        _off_policy(lambda: _multihead_dqn()),
        learn_every_k_steps=4,
    ),
    "DuelingDQN": Method(
        "DuelingDQN",
        _off_policy(
            lambda: DeepQLearning(
                q_network=DuelingQValueNetwork(),
                training_rounds=2,
                batch_size=128,
                exploration=_EPS_SCHED,
            )
        ),
        learn_every_k_steps=4,
    ),
    "QRDQN": Method(
        "QRDQN",
        _off_policy(
            lambda: QuantileRegressionDeepQLearning(
                training_rounds=2, batch_size=128, exploration=_EPS_SCHED
            )
        ),
        learn_every_k_steps=4,
    ),
    "BootstrappedDQN": Method(
        "BootstrappedDQN",
        lambda num_envs: PearlAgent(
            policy_learner=BootstrappedDQN(training_rounds=2, batch_size=128),
            replay_buffer=BootstrapReplayBuffer(capacity=_CAP, ensemble_size=10),
        ),
        learn_every_k_steps=4,
    ),
    "CQL": Method(
        "CQL",
        _off_policy(
            lambda: DeepQLearning(
                is_conservative=True,
                conservative_alpha=2.0,
                training_rounds=2,
                batch_size=128,
                exploration=_EPS_SCHED,
            )
        ),
        learn_every_k_steps=4,
    ),
    "PPO": Method(
        "PPO",
        _on_policy(
            lambda: ProximalPolicyOptimization(training_rounds=8, batch_size=256),
            rollout=128,
        ),
        learn_every_k_steps=128,
        learning_starts=0,
        on_policy_rollout=128,
    ),
    "REINFORCE": Method(
        "REINFORCE",
        _on_policy(lambda: REINFORCE(), rollout=256),
        learn_every_k_steps=256,
        learning_starts=0,
        on_policy_rollout=256,
    ),
    "SAC": Method(
        "SAC",
        _off_policy(lambda: SoftActorCritic(training_rounds=1, batch_size=256)),
        learn_every_k_steps=2,
    ),
    "ContinuousSAC": Method(
        "ContinuousSAC",
        _off_policy(lambda: ContinuousSoftActorCritic(training_rounds=1, batch_size=256)),
        continuous=True,
    ),
    "DDPG": Method(
        "DDPG",
        _off_policy(
            lambda: DeepDeterministicPolicyGradient(training_rounds=1, batch_size=256)
        ),
        continuous=True,
    ),
    "TD3": Method(
        "TD3",
        _off_policy(lambda: TD3(training_rounds=1, batch_size=256)),
        continuous=True,
    ),
    "IQL": Method(
        "IQL",
        _off_policy(lambda: ImplicitQLearning(training_rounds=1, batch_size=256)),
        continuous=True,
    ),
    "LSTMDQN": Method(
        "LSTMDQN",
        _off_policy(
            lambda: DeepQLearning(
                training_rounds=2,
                batch_size=128,
                exploration=_EPS_SCHED,
                history_summarizer=LSTMHistorySummarization(
                    history_length=8, hidden_dim=64, num_layers=1
                ),
            )
        ),
        learn_every_k_steps=4,
    ),
    # --- Variant rows mirroring the reference's LSTM / CNN / BC / dynamic
    # method dicts (benchmark_config.py LSTM_method_* :266-520, Atari
    # *_Atari_method :1462+, TD3BC in benchmark_offline_rl.py) -------------
    "TD3BC": Method(
        "TD3BC",
        _off_policy(
            lambda: _td3bc()
        ),
        continuous=True,
        env_family="continuous",
    ),
    "LSTMPPO": Method(
        "LSTMPPO",
        _on_policy(
            lambda: ProximalPolicyOptimization(
                training_rounds=20,
                batch_size=64,
                epsilon=0.1,
                actor_learning_rate=1e-4,
                critic_learning_rate=1e-4,
                history_summarizer=LSTMHistorySummarization(
                    history_length=8, hidden_dim=64, num_layers=1
                ),
            ),
            rollout=16,
        ),
        on_policy_rollout=16,
    ),
    "LSTMSAC": Method(
        "LSTMSAC",
        _off_policy(
            lambda: SoftActorCritic(
                training_rounds=2,
                batch_size=100,
                entropy_coef=0.01,
                entropy_autotune=False,
                actor_learning_rate=1e-3,
                critic_learning_rate=1e-3,
                history_summarizer=LSTMHistorySummarization(
                    history_length=8, hidden_dim=64, num_layers=1
                ),
            )
        ),
        learn_every_k_steps=4,
    ),
    "CNNDQN": Method(
        "CNNDQN",
        _off_policy(lambda: _cnn_dqn()),
        learn_every_k_steps=4,
        env_family="visual",
    ),
    # The frame-ring visual pipeline: a single-frame env, the frame ring as
    # the window, a CNN over time-major stacks and the frame replay buffer.
    "VisualDQN": Method(
        "VisualDQN",
        lambda num_envs: PearlAgent(
            policy_learner=_visual_dqn(),
            replay_buffer=VisualReplayBuffer(
                capacity=1024 * num_envs, stack=4, num_envs=num_envs
            ),
        ),
        learn_every_k_steps=4,
        env_family="visual_frames",
    ),
    # --- Risk-sensitive QR-DQN variants (reference
    # QRDQN_var_coeff_05/_2_method, benchmark_config.py:307-341): act/learn
    # under mu - beta*Var of the quantile distribution. -----------------------
    "QRDQN-Var0.5": Method(
        "QRDQN-Var0.5",
        _off_policy(lambda: _qrdqn_var(0.5)),
        learn_every_k_steps=4,
    ),
    "QRDQN-Var2": Method(
        "QRDQN-Var2",
        _off_policy(lambda: _qrdqn_var(2.0)),
        learn_every_k_steps=4,
    ),
    # Degenerate single-member ensemble (BootstrappedDQN_ensemble_1_method
    # :364-386) — isolates the bootstrap-mask effect from ensemble diversity.
    "BootstrappedDQN-1": Method(
        "BootstrappedDQN-1",
        lambda num_envs: PearlAgent(
            policy_learner=BootstrappedDQN(
                q_network=EnsembleQValueNetwork(ensemble_size=1),
                training_rounds=2,
                batch_size=128,
            ),
            replay_buffer=BootstrapReplayBuffer(capacity=_CAP, ensemble_size=1),
        ),
        learn_every_k_steps=4,
    ),
    # --- LSTM-history variants for the continuous actor-critic methods
    # (DDPG_LSTM_method :710-740, TD3_LSTM_method :772-805,
    # CSAC_LSTM_method :832-859). ---------------------------------------------
    "LSTMDDPG": Method(
        "LSTMDDPG",
        _off_policy(
            lambda: DeepDeterministicPolicyGradient(
                training_rounds=1, batch_size=256, history_summarizer=_lstm()
            )
        ),
        continuous=True,
    ),
    "LSTMTD3": Method(
        "LSTMTD3",
        _off_policy(
            lambda: TD3(training_rounds=1, batch_size=256, history_summarizer=_lstm())
        ),
        continuous=True,
    ),
    "LSTMCSAC": Method(
        "LSTMCSAC",
        _off_policy(
            lambda: ContinuousSoftActorCritic(
                training_rounds=1, batch_size=256, history_summarizer=_lstm()
            )
        ),
        continuous=True,
    ),
    # --- Dynamic-action-space variants (REINFORCE_dynamic_method :258-272,
    # PPO_dynamic_method :460-476, SAC_dynamic_method :516-531): the actor is
    # the pair-scoring DynamicActionActorNetwork (softmax over the *available*
    # actions only), and the agent stores per-step availability masks in
    # replay. Pair with DynamicActionSpaceWrapper envs. -----------------------
    "DynamicREINFORCE": Method(
        "DynamicREINFORCE",
        lambda num_envs: PearlAgent(
            policy_learner=REINFORCE(actor_network=_dyn_actor()),
            replay_buffer=OnPolicyReplayBuffer(
                capacity=256 * num_envs, num_envs=num_envs
            ),
            track_available_masks=True,
        ),
        learn_every_k_steps=256,
        learning_starts=0,
        on_policy_rollout=256,
    ),
    "DynamicPPO": Method(
        "DynamicPPO",
        lambda num_envs: PearlAgent(
            policy_learner=ProximalPolicyOptimization(
                training_rounds=8, batch_size=256, actor_network=_dyn_actor()
            ),
            replay_buffer=OnPolicyReplayBuffer(
                capacity=128 * num_envs, num_envs=num_envs
            ),
            track_available_masks=True,
        ),
        learn_every_k_steps=128,
        learning_starts=0,
        on_policy_rollout=128,
    ),
    "DynamicSAC": Method(
        "DynamicSAC",
        lambda num_envs: PearlAgent(
            policy_learner=SoftActorCritic(
                training_rounds=1, batch_size=256, actor_network=_dyn_actor()
            ),
            replay_buffer=BasicReplayBuffer(capacity=_CAP),
            track_available_masks=True,
        ),
        learn_every_k_steps=2,
    ),
    # Discrete IQL (IQL_online_method :598-626; our "IQL" row is the
    # continuous CIQL_online_method :653-681 — continuity follows the env's
    # action space).
    "DiscreteIQL": Method(
        "DiscreteIQL",
        _off_policy(lambda: ImplicitQLearning(training_rounds=1, batch_size=256)),
        learn_every_k_steps=2,
    ),
    # --- Reward-constrained (RCPO) variants at constraint 0.2
    # (RCDDPG/RCTD3/RCCSAC_method_const_0_2 :860-1002): cost critic +
    # Lagrangian reward shaping via the RC safety module. Pair with a
    # cost-emitting env (e.g. Pendulum(emit_torque_cost=True)). ---------------
    "RCDDPG": Method(
        "RCDDPG",
        lambda num_envs: _rc_agent(
            DeepDeterministicPolicyGradient(training_rounds=1, batch_size=256)
        ),
        continuous=True,
    ),
    "RCTD3": Method(
        "RCTD3",
        lambda num_envs: _rc_agent(TD3(training_rounds=1, batch_size=256)),
        continuous=True,
    ),
    "RCCSAC": Method(
        "RCCSAC",
        lambda num_envs: _rc_agent(
            ContinuousSoftActorCritic(training_rounds=1, batch_size=256)
        ),
        continuous=True,
    ),
    # Discrete RC rows (RCSAC/RCPPO/RCREINFORCE_method_const_0_2 :1003-1070):
    # the same cost critic + Lagrangian over one-hot action representations.
    "RCSAC": Method(
        "RCSAC",
        lambda num_envs: _rc_agent(
            SoftActorCritic(training_rounds=1, batch_size=256, entropy_coef=0.1)
        ),
        learn_every_k_steps=2,
    ),
    "RCPPO": Method(
        "RCPPO",
        lambda num_envs: _rc_agent(
            ProximalPolicyOptimization(training_rounds=8, batch_size=256),
            buffer=OnPolicyReplayBuffer(capacity=128 * num_envs, num_envs=num_envs),
        ),
        learn_every_k_steps=128,
        learning_starts=0,
        on_policy_rollout=128,
    ),
    "RCREINFORCE": Method(
        "RCREINFORCE",
        lambda num_envs: _rc_agent(
            REINFORCE(),
            buffer=OnPolicyReplayBuffer(capacity=256 * num_envs, num_envs=num_envs),
        ),
        learn_every_k_steps=256,
        learning_starts=0,
        on_policy_rollout=256,
    ),
    # --- CNN (Atari-topology) actor-critic variants on the on-device visual
    # env (PPO_Atari_method :403-434, SAC_Atari/SAC_multi_head_Atari_method
    # :532-597; the ALE emulator itself is host-side: see envs/atari.py and
    # training/host_loop.py). --------------------------------------------------
    "CNNPPO": Method(
        "CNNPPO",
        lambda num_envs: PearlAgent(
            policy_learner=ProximalPolicyOptimization(
                training_rounds=8,
                batch_size=256,
                actor_network=_cnn_actor(),
                critic_network=_cnn_value(),
            ),
            replay_buffer=OnPolicyReplayBuffer(
                capacity=128 * num_envs, num_envs=num_envs
            ),
        ),
        learn_every_k_steps=128,
        learning_starts=0,
        on_policy_rollout=128,
        env_family="visual",
    ),
    "CNNSAC": Method(
        "CNNSAC",
        _off_policy(
            lambda: SoftActorCritic(
                training_rounds=1,
                batch_size=256,
                actor_network=_cnn_actor(),
                critic_network=_cnn_twin_critic(),
            )
        ),
        learn_every_k_steps=4,
        env_family="visual",
    ),
}

_BREAKOUT_CNN = dict(
    input_shape=(10, 10, 4),
    out_channels=(16, 32),
    kernel_sizes=(3, 3),
    strides=(1, 1),
    paddings=(1, 1),
    hidden_dims=(128,),
)


def _cnn_actor():
    from pearl_tpu_torch.neural_networks.actor_networks import CNNActorNetwork

    return CNNActorNetwork(**_BREAKOUT_CNN)


def _cnn_value():
    from pearl_tpu_torch.neural_networks.value_networks import CNNValueNetwork

    return CNNValueNetwork(**_BREAKOUT_CNN)


def _cnn_twin_critic():
    from pearl_tpu_torch.neural_networks.twin_critic import CNNTwinCritic

    return CNNTwinCritic(**_BREAKOUT_CNN)


def _lstm():
    return LSTMHistorySummarization(history_length=8, hidden_dim=64, num_layers=1)


def _dyn_actor():
    from pearl_tpu_torch.neural_networks.actor_networks import DynamicActionActorNetwork

    return DynamicActionActorNetwork()


def _qrdqn_var(coefficient: float):
    from pearl_tpu_torch.safety_modules.risk_sensitive import (
        QuantileNetworkMeanVarianceSafetyModule,
    )

    return QuantileRegressionDeepQLearning(
        training_rounds=2,
        batch_size=128,
        exploration=_EPS_SCHED,
        safety=QuantileNetworkMeanVarianceSafetyModule(
            variance_weighting_coefficient=coefficient
        ),
    )


def _rc_agent(learner, buffer=None):
    from pearl_tpu_torch.safety_modules import RCSafetyModuleCostCriticContinuousAction

    return PearlAgent(
        policy_learner=learner,
        replay_buffer=buffer if buffer is not None else BasicReplayBuffer(capacity=_CAP),
        safety_module=RCSafetyModuleCostCriticContinuousAction(
            constraint_value=0.2, batch_size=256
        ),
        store_cost=True,
    )


def _multihead_dqn():
    """state -> |A| heads (reference VanillaQValueMultiHeadNetwork,
    q_value_networks.py:186-250): one B-row product per act instead of B*A
    rows, through the fused MLP kernel; bench.py's DQN network."""
    from pearl_tpu_torch.neural_networks.q_value_networks import MultiHeadQValueNetwork

    return DeepQLearning(
        q_network=MultiHeadQValueNetwork(),
        training_rounds=2,
        batch_size=128,
        exploration=_EPS_SCHED,
    )


def _td3bc():
    from pearl_tpu_torch.policy_learners.sequential_decision_making import TD3BC

    return TD3BC(training_rounds=1, batch_size=256)


def _cnn_dqn():
    """Breakout-scale CNN DQN (the on-device stand-in for the reference's
    Atari methods; pair with pearl_tpu_torch.envs.Breakout)."""
    from pearl_tpu_torch.neural_networks.q_value_networks import CNNQValueNetwork

    return DeepQLearning(
        q_network=CNNQValueNetwork(
            input_shape=(10, 10, 4),
            out_channels=(16, 32),
            kernel_sizes=(3, 3),
            strides=(1, 1),
            paddings=(1, 1),
            hidden_dims=(128,),
        ),
        training_rounds=1,
        batch_size=512,
        exploration=_EPS_SCHED,
    )


def _visual_dqn():
    """Frame-history CNN DQN over single-frame observations:
    FrameRingHistorySummarization (a circular window written one frame a
    step) paired with VisualReplayBuffer, the path of the ring-write and
    fence kernels."""
    from pearl_tpu_torch.history_summarization_modules import (
        FrameRingHistorySummarization,
    )
    from pearl_tpu_torch.neural_networks.q_value_networks import CNNQValueNetwork

    return DeepQLearning(
        q_network=CNNQValueNetwork(
            input_shape=(12, 12, 4),
            out_channels=(16, 32),
            kernel_sizes=(3, 3),
            strides=(1, 1),
            paddings=(1, 1),
            hidden_dims=(128,),
            time_major_stack=True,
        ),
        training_rounds=1,
        batch_size=128,
        exploration=_EPS_SCHED,
        history_summarizer=FrameRingHistorySummarization(history_length=4),
    )


def make_agent(method: Method, num_envs: int) -> PearlAgent:
    return method.make_agent(num_envs)


# --- Experiment presets (reference benchmark_config.py:1152-1176) -----------
# Budgets mirror the reference: classic-control 100k env steps, "mujoco-scale"
# continuous control 500k, 4 seeds, record every 1000 steps.
CLASSIC_CONTROL_STEPS = 100_000
CONTINUOUS_CONTROL_STEPS = 500_000
NUM_RUNS = 4
RECORD_PERIOD = 1_000


def classic_control_experiments():
    """Method x env grid for discrete classic control."""
    from pearl_tpu_torch.envs import Acrobot, CartPole, MountainCar

    return {
        "methods": [
            "DQN", "DoubleDQN", "SARSA", "DuelingDQN", "QRDQN",
            "BootstrappedDQN", "CQL", "PPO", "REINFORCE", "SAC",
        ],
        "envs": {
            "CartPole": CartPole,
            "Acrobot": Acrobot,
            "MountainCar": MountainCar,
        },
        "max_steps": CLASSIC_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def continuous_control_experiments():
    from pearl_tpu_torch.envs import ContinuousMountainCar, Pendulum

    return {
        "methods": ["ContinuousSAC", "DDPG", "TD3", "IQL"],
        "envs": {
            "Pendulum": Pendulum,
            "ContinuousMountainCar": ContinuousMountainCar,
        },
        "max_steps": CONTINUOUS_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def ple_experiments():
    """PLE game grid incl. the PuckWorld wrapper variants the reference
    benchmarks (benchmark_config.py:1130-1151 PO/SR lists, :1715-1723 env
    construction; user_envs/__init__.py:9-51 registrations). The PO variant
    hides velocities (history methods recover them), SR pays 1 only near the
    target, SF adds the high-variance risky half-plane reward."""
    import torch

    from pearl_tpu_torch.envs import (
        Catcher,
        FlappyBird,
        PartialObservabilityWrapper,
        Pixelcopter,
        Pong,
        PuckWorld,
        SafetyWrapper,
        SparseRewardWrapper,
    )

    def puckworld_po():
        # Hide velocities (indices 2, 3) — reference
        # wrappers/partial_observability.py PuckWorld variant.
        return PartialObservabilityWrapper(
            PuckWorld(), observed_indices=(0, 1, 4, 5, 6, 7)
        )

    def puckworld_sr():
        # 1 when the puck is within 0.1 of the target (sparse_reward.py:92-103).
        def success(obs):
            return torch.linalg.norm(obs[..., 0:2] - obs[..., 4:6], dim=-1) < 0.1

        return SparseRewardWrapper(PuckWorld(), success_fn=success)

    def puckworld_sf():
        # Risky half-plane x > 1/2 with N(0.01, 0.1) bonus (safety.py:26-34).
        def risky(obs, action):
            return obs[..., 0] > 0.5

        return SafetyWrapper(
            PuckWorld(), risky_fn=risky, noisy_reward_sigma=0.1
        )

    return {
        "methods": ["DQN", "LSTMDQN", "LSTMPPO", "LSTMSAC", "BootstrappedDQN"],
        "envs": {
            "Catcher": Catcher,
            "FlappyBird": FlappyBird,
            "Pixelcopter": Pixelcopter,
            "Pong": Pong,
            "PuckWorld": PuckWorld,
            "PuckWorld-PO": puckworld_po,
            "PuckWorld-SR": puckworld_sr,
            "PuckWorld-SF": puckworld_sf,
        },
        "max_steps": CLASSIC_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def dynamic_action_experiments():
    """Dynamic-action-space variants (reference benchmark_config.py's
    *_dynamic method dicts + DynamicActionSpaceWrapper,
    wrappers/dynamic_action_env.py:19-48): CartPole/Acrobot with the last
    action masked out every other interval; agents must track the
    availability masks end-to-end (replay stores curr/next masks)."""
    import dataclasses as _dc

    from pearl_tpu_torch.envs import Acrobot, CartPole, DynamicActionSpaceWrapper

    def wrap(make_env):
        return lambda: DynamicActionSpaceWrapper(make_env(), interval=4, num_masked=1)

    def with_masks(name):
        base = METHODS[name]
        make = base.make_agent

        def make_agent(num_envs):
            return _dc.replace(make(num_envs), track_available_masks=True)

        return _dc.replace(base, make_agent=make_agent)

    return {
        "methods": {n: with_masks(n) for n in ("DQN", "DoubleDQN", "SARSA")},
        "envs": {
            # Acrobot has 3 actions -> masking one leaves a real choice.
            "DynamicAcrobot": wrap(Acrobot),
            "DynamicCartPole": wrap(CartPole),
        },
        "max_steps": CLASSIC_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def rc_constrained_experiments():
    """Reward-constrained (RCPO) grid (reference benchmark_config.py's
    RC*-method experiment lists, :1160-1461): constrained methods on
    cost-emitting continuous-control envs, sweeping the constraint value.
    The output of interest is the return/episode-cost tradeoff per
    constraint (examples/rc_safety_pendulum.py plots one slice)."""
    import dataclasses as _dc

    from pearl_tpu_torch.envs import Pendulum

    def at_constraint(name, value):
        base = METHODS[name]
        make = base.make_agent

        def make_agent(num_envs):
            agent = make(num_envs)
            return _dc.replace(
                agent,
                safety_module=_dc.replace(
                    agent.safety_module, constraint_value=value
                ),
            )

        return _dc.replace(base, make_agent=make_agent)

    constraints = (0.05, 0.1, 0.2)
    return {
        "methods": {
            f"{n}-c{c}": at_constraint(n, c)
            for n in ("RCDDPG", "RCTD3", "RCCSAC")
            for c in constraints
        },
        "envs": {"PendulumCost": lambda: Pendulum(emit_torque_cost=True)},
        "max_steps": CLASSIC_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def visual_experiments():
    """CNN-method grid on the on-device visual env (reference Atari
    experiments, benchmark_config.py:1462-1676; the ALE emulator is
    host-side — envs/atari.py + training/host_loop.py run that topology)."""
    from pearl_tpu_torch.envs import Breakout

    return {
        "methods": ["CNNDQN", "CNNPPO", "CNNSAC"],
        "envs": {"Breakout": Breakout},
        "max_steps": CLASSIC_CONTROL_STEPS,
        "num_runs": NUM_RUNS,
        "record_period": RECORD_PERIOD,
    }


def cb_benchmark_experiments():
    """CB methods x envs (reference cb_benchmark_config.py:40-242: SquareCB /
    FastCB / NeuralLinUCB / NeuralLinTS over UCI datasets; datasets here are
    local-array classification envs)."""
    from pearl_tpu_torch.envs import LinearSyntheticBanditEnvironment
    from pearl_tpu_torch.policy_learners.contextual_bandits import (
        LinearBandit,
        NeuralLinearBandit,
    )
    from pearl_tpu_torch.policy_learners.exploration_modules.contextual_bandits import (
        FastCBExploration,
        SquareCBExploration,
        ThompsonSamplingExplorationLinear,
        UCBExploration,
    )

    return {
        "methods": {
            "LinUCB": lambda: LinearBandit(exploration=UCBExploration(alpha=1.0)),
            "LinTS": lambda: LinearBandit(
                exploration=ThompsonSamplingExplorationLinear()
            ),
            "SquareCB": lambda: LinearBandit(
                exploration=SquareCBExploration(gamma=10.0)
            ),
            "FastCB": lambda: LinearBandit(exploration=FastCBExploration(gamma=10.0)),
            "NeuralLinUCB": lambda: NeuralLinearBandit(
                exploration=UCBExploration(alpha=1.0)
            ),
            "NeuralLinTS": lambda: NeuralLinearBandit(
                exploration=ThompsonSamplingExplorationLinear()
            ),
        },
        "envs": {"linear_synthetic": LinearSyntheticBanditEnvironment},
        "steps": 5_000,
    }
