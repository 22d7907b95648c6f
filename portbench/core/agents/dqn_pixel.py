"""The program's pixel DQN agent, built from a configuration file.

Imports the port only when called, so that loading the harness loads nothing
of the program.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch

from portbench.core.compare import frame_print, print_vector


def build(config: dict, num_envs: int):
    """(agent, env) of the port: `CNNQValueNetwork` over a bfloat16 frame
    ring, `DeepQLearning` with epsilon-greedy, `VisualReplayBuffer`,
    `SyntheticAtari`."""
    from pearl_tpu_torch.agent import PearlAgent
    from pearl_tpu_torch.envs import SyntheticAtari
    from pearl_tpu_torch.history_summarization_modules import FrameRingHistorySummarization
    from pearl_tpu_torch.neural_networks import CNNQValueNetwork
    from pearl_tpu_torch.policy_learners.exploration_modules import EGreedyExploration
    from pearl_tpu_torch.policy_learners.sequential_decision_making import DeepQLearning
    from pearl_tpu_torch.replay_buffers import VisualReplayBuffer

    net, env_cfg, learner, replay = (
        config["network"], config["env"], config["learner"], config["replay"])
    T = config["history_length"]
    env = SyntheticAtari(
        height=env_cfg["height"], width=env_cfg["width"], frames=env_cfg["frames"],
        num_actions=env_cfg["num_actions"], episode_len=env_cfg["episode_len"],
        obs_dtype=getattr(torch, env_cfg["obs_dtype"]),
    )
    agent = PearlAgent(
        policy_learner=DeepQLearning(
            q_network=CNNQValueNetwork(
                input_shape=(env_cfg["height"], env_cfg["width"], T * env_cfg["frames"]),
                out_channels=tuple(net["out_channels"]),
                kernel_sizes=tuple(net["kernel_sizes"]),
                strides=tuple(net["strides"]),
                paddings=tuple(net["paddings"]),
                hidden_dims=tuple(net["hidden_dims"]),
                time_major_stack=True,
            ),
            exploration=EGreedyExploration(epsilon=learner["epsilon"]),
            training_rounds=learner["training_rounds"],
            batch_size=learner["batch_size"],
            learning_rate=learner["learning_rate"],
            weight_decay=learner["weight_decay"],
            discount_factor=learner["discount_factor"],
            target_update_freq=learner["target_update_freq"],
            soft_update_tau=learner["soft_update_tau"],
            act_dtype=config["precision"]["act"],
            history_summarizer=FrameRingHistorySummarization(
                history_length=T, dtype=getattr(torch, config["ring_dtype"])),
        ),
        replay_buffer=VisualReplayBuffer(
            capacity=replay["capacity"], stack=replay["stack"], num_envs=num_envs,
            frame_dtype=getattr(torch, replay["frame_dtype"]), dedup_next=replay["dedup_next"],
        ),
    )
    return agent, env


def init_state(agent, env, num_envs: int, seed: int, device):
    """The agent's state from `PearlAgent.init` (replay allocated), before the
    first reset: the driver replaces its per-env leaves at its first call."""
    bound = agent.for_env(env)
    obs = torch.zeros((num_envs, env.observation_dim), dtype=env.obs_dtype or torch.float32,
                      device=device)
    return bound.init(seed, env.observation_dim, num_envs, obs, device=device)


@torch.no_grad()
def load_weights(learner_state, weights: List[torch.Tensor]) -> None:
    """Copy the benchmark's weights ([w0, b0, w1, b1, ...] in layer order)
    into the online and the target network; the act copy is recast from the
    online one at its next use."""
    for module in (learner_state.params, learner_state.target_params):
        params = list(module.parameters())
        if len(params) != len(weights):
            raise ValueError(f"the network has {len(params)} tensors, the weights {len(weights)}")
        for p, w in zip(params, weights):
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"shape {tuple(p.shape)} against the weights' {tuple(w.shape)}")
            p.copy_(w)


class LearnProbe:
    """Wraps `PearlAgent.learn` during set-up and keeps, of the learns that
    the comparison reads: the reported loss of the first `n_losses`; the
    first gradient as the optimizer holds it; the online and target networks
    after each learn in `keep`; and for each learn in `stage`, both networks
    before it, its reported loss and the gradient it stepped with."""

    def __init__(self, n_losses: int, keep: Sequence[int], stage: Sequence[int], beta1: float):
        self.n_losses, self.keep, self.stage, self.beta1 = n_losses, set(keep), set(stage), beta1
        self.count = 0
        self.losses: List[torch.Tensor] = []
        self.grads1: Optional[List[torch.Tensor]] = None
        self.params: Dict[int, List[torch.Tensor]] = {}
        self.target: Dict[int, List[torch.Tensor]] = {}
        self.staged: Dict[int, dict] = {}
        self._restore = None

    def install(self) -> None:
        from pearl_tpu_torch.agent.pearl_agent import PearlAgent

        probe, orig = self, PearlAgent.learn

        @functools.wraps(orig)
        def learn(agent, astate, generator, indices=None):
            probe._before(astate.learner)
            out = orig(agent, astate, generator, indices)
            probe._after(*out)
            return out

        self._restore = (PearlAgent, orig)
        PearlAgent.learn = learn

    def _before(self, ls) -> None:
        j = self.count + 1
        if j in self.stage:
            self.staged[j] = {"params": _clone(ls.params), "target": _clone(ls.target_params)}

    def _after(self, astate, metrics) -> None:
        self.count += 1
        j, ls = self.count, astate.learner
        if j <= self.n_losses:
            self.losses.append(metrics["loss"].detach().clone())
        if j == 1:
            self.grads1 = first_gradient(ls, self.beta1)
        if j in self.keep:
            self.params[j], self.target[j] = _clone(ls.params), _clone(ls.target_params)
        if j in self.stage:
            self.staged[j].update(loss=metrics["loss"].detach().clone(), grads=[
                torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                for p in ls.params.parameters()])

    def remove(self) -> None:
        if self._restore is not None:
            cls, orig = self._restore
            cls.learn = orig
            self._restore = None


def _clone(module) -> List[torch.Tensor]:
    return [p.detach().clone() for p in module.parameters()]


def first_gradient(learner_state, beta1: float) -> List[torch.Tensor]:
    """The first learn's gradient as the optimizer got it: AdamW's first
    moment after one step is (1 - beta1) g."""
    opt = learner_state.optimizer
    out = []
    for p in learner_state.params.parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out.append(torch.zeros_like(p) if m is None else m.detach() / (1.0 - beta1))
    return out


class Recorder:
    """What the comparison reads of set-up's dispatches, in the form the
    reference's `judge` documents. After each dispatch it reads back that
    dispatch's pushes (replay columns, frame prints of every row, and the
    frames of the sampled `envs`), before a later push can overwrite them;
    after the last it reads back every push still resident, the envs' state
    and every env's acting window. The learn probe keeps the learns the
    reference's `judged_learns` names."""

    def __init__(self, spec, traffic: dict, print_seed: int, envs: torch.Tensor,
                 keep: Sequence[int], stage: Sequence[int]):
        B = traffic["num_envs"]
        self.B, self.steps = B, traffic["learn_every_k_steps"] * traffic["chunks_per_dispatch"]
        self.cap_pushes = spec.capacity // B
        self.history, self.envs = spec.history, envs
        self.vector = print_vector(print_seed, spec.height * spec.width, envs.device)
        self.probe = (LearnProbe(3, keep, stage, spec.betas[0]) if traffic["learn"] else None)
        self.rows: List[dict] = []
        self.frames: List[dict] = []

    def install(self) -> None:
        if self.probe is not None:
            self.probe.install()

    def remove(self) -> None:
        if self.probe is not None:
            self.probe.remove()

    def _read(self, agent_state, pushes: range, frames: bool) -> None:
        st = agent_state.replay.storage
        rest, B = st["rest"], self.B
        slots = torch.tensor([p % self.cap_pushes for p in pushes], device=st["seq"].device)
        rows = (slots[:, None] * B + torch.arange(B, device=slots.device)).flatten()
        trunc = rest.truncated[rows].view(-1, B)
        prints_s, prints_t = [], []
        for i in range(len(slots)):
            lo = int(slots[i]) * B
            prints_s.append(frame_print(st["frame_s"][lo:lo + B], self.vector))
            prints_t.append(torch.where(trunc[i], frame_print(st["frame_t"][lo:lo + B],
                                                              self.vector), 0.0))
        self.rows.append({
            "push": torch.tensor(list(pushes), device=slots.device),
            "action": rest.action_index[rows].view(-1, B).clone(),
            "reward": rest.reward[rows].view(-1, B).clone(),
            "truncated": trunc.clone(),
            "terminated": rest.terminated[rows].view(-1, B).clone(),
            "seq": st["seq"][slots].clone(),
            "print_s": torch.stack(prints_s), "print_t": torch.stack(prints_t),
        })
        if frames:
            F = st["frame_s"].shape[1]
            pick = (slots[:, None] * B + self.envs[None, :]).flatten()
            self.frames.append({name: st[name][pick].view(len(slots), -1, F).clone()
                                for name in ("frame_s", "frame_t")})

    def after_dispatch(self, i: int, agent_state, env_states) -> None:
        self._read(agent_state, range(i * self.steps, (i + 1) * self.steps), frames=True)

    def outputs(self, agent_state, env_states, dispatches: int) -> dict:
        total = dispatches * self.steps
        self._read(agent_state, range(max(total - self.cap_pushes, 0), total), frames=False)
        fresh = self.rows[:-1]
        rows = {name: torch.cat([r[name] for r in self.rows]) for name in self.rows[0]}
        carry = agent_state.history_carry
        T = self.history
        order = [(carry.cursor + i) % T for i in range(T)]
        window = carry.ring[:, order] * carry.valid[:, order][..., None].to(carry.ring.dtype)
        out = {
            "actions": torch.cat([r["action"] for r in fresh]),
            "rows": rows,
            "frames": {name: torch.cat([f[name] for f in self.frames])
                       for name in ("frame_s", "frame_t")},
            "window": window,
            "env": {"phase": env_states.phase.clone(), "t": env_states.t.clone()},
            "envs": self.envs,
        }
        if self.probe is not None:
            p = self.probe
            out.update(losses=p.losses, grads1=p.grads1, params=p.params, target=p.target,
                       stage=p.staged)
        return out
