"""Plain reference of pixel DQN as `online_learning` runs it.

What it computes, each part written from its published semantics and from
nothing of the program:

- SyntheticAtari: a frame of env e at step t of its episode is
  `sin(phase + 0.11 h + 0.07 w + 0.5 f + 0.31 t)` over an 84 x 84 grid,
  rounded to the observation dtype; episodes last `episode_len` steps and end
  truncated; the reward is 1 when the action equals
  `(floor(10 phase) + t) % num_actions`. A finished env restarts at t = 0
  with a fresh phase.
- The window the agent acts on: the last `history` observations of the
  current episode, oldest first, zeros before the episode's start.
- Replay: one row per env and step; a learn draws `batch_size` rows
  uniformly from every resident push but the newest (the dedup layout needs
  its successor), and rebuilds each row's state and next-state windows from
  its (phase, t): the frames are a function of them, so no frame is stored.
- The network: conv layers with relu over frames / 255, flatten in (C, H, W)
  order, relu hidden layers, one linear output per action.
- DQN: target r + gamma (1 - terminated) max_a Q_target(s', a), mean squared
  TD error, AdamW (decoupled weight decay), a soft target update
  t <- t + tau (p - t) every `target_update_freq` learns.
- epsilon-greedy: explore where u0 < epsilon, the random action being the
  argmax of A more uniforms.

The random draws follow the seed through the driver's documented order: one
(B,) uniform for the initial reset, then per vector step one (B, 1 + A)
uniform for the act and one (B,) uniform for the reset that a finished env
takes, then one randint per learn. The reference draws them itself from a
generator seeded as the driver seeds its own.

`precision` picks how the network computes: "float32" (TF32 off, the
reference), "tf32" (float32 with TF32 products and convolutions), "bfloat16"
and "fp8" (e4m3 values with per-tensor scales, the products summed in
float32 and each layer's output rounded to bfloat16): the last three are
the controls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.core.compare import frame_print, leaf_gaps, moved_leaves, print_vector, worst


@dataclasses.dataclass(frozen=True)
class Spec:
    height: int
    width: int
    history: int
    num_actions: int
    episode_len: int
    obs_dtype: torch.dtype
    out_channels: Sequence[int]
    kernel_sizes: Sequence[int]
    strides: Sequence[int]
    paddings: Sequence[int]
    hidden_dims: Sequence[int]
    batch_size: int
    capacity: int
    gamma: float
    learning_rate: float
    weight_decay: float
    betas: Sequence[float]
    adam_eps: float
    epsilon: float
    target_update_freq: int
    tau: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        net, env, learner = cfg["network"], cfg["env"], cfg["learner"]
        return cls(
            height=env["height"], width=env["width"], history=cfg["history_length"],
            num_actions=env["num_actions"], episode_len=env["episode_len"],
            obs_dtype=getattr(torch, env["obs_dtype"]),
            out_channels=tuple(net["out_channels"]), kernel_sizes=tuple(net["kernel_sizes"]),
            strides=tuple(net["strides"]), paddings=tuple(net["paddings"]),
            hidden_dims=tuple(net["hidden_dims"]),
            batch_size=learner["batch_size"], capacity=cfg["replay"]["capacity"],
            gamma=learner["discount_factor"], learning_rate=learner["learning_rate"],
            weight_decay=learner["weight_decay"], betas=tuple(learner["betas"]),
            adam_eps=learner["adam_eps"], epsilon=learner["epsilon"],
            target_update_freq=learner["target_update_freq"], tau=learner["soft_update_tau"],
        )


# ------------------------------------------------------------------ network
def layer_shapes(spec: Spec) -> List[dict]:
    """Each layer's weight and bias shapes, stride and padding, in order."""
    H, W, c = spec.height, spec.width, spec.history
    layers = []
    for oc, k, s, p in zip(spec.out_channels, spec.kernel_sizes, spec.strides, spec.paddings):
        H, W = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        layers.append({"kind": "conv", "w": (oc, c, k, k), "b": (oc,), "stride": s,
                       "padding": p})
        c = oc
    d = c * H * W
    for h in (*spec.hidden_dims, spec.num_actions):
        layers.append({"kind": "dense", "w": (h, d), "b": (h,)})
        d = h
    return layers


def init_weights(spec: Spec, seed: int, device) -> List[torch.Tensor]:
    """[w0, b0, w1, b1, ...]: weights normal with variance 1 / fan_in from one
    draw of a generator on `device`, biases zero; float32."""
    shapes = layer_shapes(spec)
    sizes = [math.prod(layer["w"]) for layer in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = [], 0
    for layer, n in zip(shapes, sizes):
        fan_in = math.prod(layer["w"][1:])
        out.append(z[off:off + n].view(layer["w"]) / math.sqrt(fan_in))
        out.append(torch.zeros(layer["b"], device=device))
        off += n
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def q_values(spec: Spec, params: Sequence[torch.Tensor], x: torch.Tensor,
             precision: str = "float32") -> torch.Tensor:
    """Q (N, A) in float32 of windows `x` (N, T, H, W), oldest frame first."""
    shapes = layer_shapes(spec)
    if precision == "tf32":
        with tf32():
            return q_values(spec, params, x, "float32")
    if precision == "float32":
        cast, wcast = (lambda t: t.float()), (lambda t: t.float())
    elif precision == "bfloat16":
        cast, wcast = (lambda t: t.to(torch.bfloat16)), (lambda t: t.to(torch.bfloat16))
    elif precision == "fp8":
        cast, wcast = _fp8, _fp8
    else:
        raise ValueError(f"unknown precision {precision!r}")
    y = cast(x.float() / 255.0)
    for i, layer in enumerate(shapes):
        w, b = wcast(params[2 * i]), params[2 * i + 1]
        b = b.to(y.dtype) if precision != "fp8" else b.float()
        if layer["kind"] == "conv":
            y = F.conv2d(y, w, b, stride=layer["stride"], padding=layer["padding"])
        else:
            y = F.linear(y.flatten(1), w, b)
        if i < len(shapes) - 1:
            y = F.relu(y)
        if precision == "fp8":
            y = y.to(torch.bfloat16)
            if i < len(shapes) - 1:
                y = _fp8(y)
    return y.float()


@contextlib.contextmanager
def _tf32_flags(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def exact_float32():
    """float32 products and convolutions without TF32."""
    return _tf32_flags(False)


def tf32():
    """float32 products and convolutions in TF32."""
    return _tf32_flags(True)


# ---------------------------------------------------------------------- env
def frames(spec: Spec, phase: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Frames (N, H, W) at steps `t` (N,) of episodes of `phase` (N,), in the
    observation dtype, returned as float32."""
    dev = phase.device
    h = torch.arange(spec.height, dtype=torch.float32, device=dev)[None, :, None]
    w = torch.arange(spec.width, dtype=torch.float32, device=dev)[None, None, :]
    f = torch.zeros((), dtype=torch.float32, device=dev)
    grid = torch.sin(phase[:, None, None] + 0.11 * h + 0.07 * w + 0.5 * f
                     + 0.31 * t.to(torch.float32)[:, None, None])
    return grid.to(spec.obs_dtype).float()


def window(spec: Spec, phase: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The acting window (N, T, H, W) at step `t`: frames t - T + 1 .. t of
    the episode, oldest first, zeros before its start."""
    T = spec.history
    out = []
    for j in range(T - 1, -1, -1):
        tj = t - j
        fr = frames(spec, phase, tj.clamp(min=0))
        out.append(fr * (tj >= 0).to(fr.dtype)[:, None, None])
    return torch.stack(out, dim=1)


def target_action(spec: Spec, phase: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (torch.floor(phase * 10.0).to(torch.int32) + t.to(torch.int32)) % spec.num_actions


# ---------------------------------------------------------------- learning
class AdamW:
    """torch.optim.AdamW's update written out: decoupled decay, then Adam
    with bias corrections, eps outside the square root."""

    def __init__(self, spec: Spec, params: Sequence[torch.Tensor]):
        self.spec = spec
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step_count = 0

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        s = self.spec
        b1, b2 = s.betas
        self.step_count += 1
        bc1 = 1 - b1 ** self.step_count
        bc2 = 1 - b2 ** self.step_count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            p.mul_(1 - s.learning_rate * s.weight_decay)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(bc2) + s.adam_eps
            p.addcdiv_(m, denom, value=-s.learning_rate / bc1)




def td_grad(spec: Spec, params: Sequence[torch.Tensor], target: Sequence[torch.Tensor], batch,
            precision: str = "float32"):
    """(mean |TD error|, the gradients of the mean squared TD error) of one
    DQN learn on `batch` from `params` and `target`, without a step."""
    s, n, action, reward, terminated = batch
    leaves = [p.detach().requires_grad_(True) for p in params]
    q = q_values(spec, leaves, s, precision)
    q_sa = q.gather(1, action.long()[:, None])[:, 0]
    with torch.no_grad():
        next_v = q_values(spec, target, n, precision).max(dim=-1).values
        y = reward + spec.gamma * (1.0 - terminated.float()) * next_v
    td = q_sa - y
    grads = torch.autograd.grad((td ** 2).mean(), leaves)
    return td.detach().abs().mean(), [g.detach() for g in grads]


def td_step(spec: Spec, params: List[torch.Tensor], target: List[torch.Tensor], opt: AdamW,
            batch, precision: str = "float32"):
    """One DQN learn on `batch`; updates `params` (and `target` on a target
    step) in place. Returns (mean |TD error|, the gradients)."""
    loss, grads = td_grad(spec, params, target, batch, precision)
    opt.step(params, grads)
    if opt.step_count % spec.target_update_freq == 0:
        with torch.no_grad():
            for t, p in zip(target, params):
                t.add_(p - t, alpha=spec.tau)
    return loss, grads


# ------------------------------------------------------------------- replay
@dataclasses.dataclass
class History:
    """Per push (rows) and env (columns): the acting observation's phase and
    step, the action, reward and truncation of the step, and with a print
    vector the prints of the acting frame and of a truncated row's final
    frame (0 elsewhere)."""

    phase: List[torch.Tensor] = dataclasses.field(default_factory=list)
    t: List[torch.Tensor] = dataclasses.field(default_factory=list)
    action: List[torch.Tensor] = dataclasses.field(default_factory=list)
    reward: List[torch.Tensor] = dataclasses.field(default_factory=list)
    truncated: List[torch.Tensor] = dataclasses.field(default_factory=list)
    print_s: List[torch.Tensor] = dataclasses.field(default_factory=list)
    print_t: List[torch.Tensor] = dataclasses.field(default_factory=list)


def sample_range(spec: Spec, pushes: int, num_envs: int, lost: Optional[int] = None):
    """(oldest sampled push, rows sampled) after `pushes` pushes: every
    resident push but the newest, whose successor is not written yet; once
    the ring has wrapped, the oldest `lost` (history - 1) resident pushes have
    lost the older frames of their windows and are left out too."""
    cap = spec.capacity // num_envs
    lost = spec.history - 1 if lost is None else lost
    oldest = 0 if pushes <= cap else pushes - cap + lost
    return oldest, max(pushes - 1 - oldest, 1) * num_envs


def learn_batch_windows(spec: Spec, hist: History, push: torch.Tensor, env: torch.Tensor):
    """(state windows, next-state windows, action, reward, terminated) of the
    rows (push, env)."""
    phase = torch.stack(hist.phase)[push, env]
    t = torch.stack(hist.t)[push, env]
    s = window(spec, phase, t)
    n = window(spec, phase, t + 1)  # the post-step (or truncation) frame is newest
    action = torch.stack(hist.action)[push, env]
    reward = torch.stack(hist.reward)[push, env]
    terminated = torch.zeros_like(reward, dtype=torch.bool)
    return s, n, action, reward, terminated


# -------------------------------------------------------------- simulation
@dataclasses.dataclass
class Run:
    """What `simulate` produced or judged."""

    hist: History
    losses: List[torch.Tensor]  # mean |TD| of each learn
    grads1: Optional[List[torch.Tensor]]  # the first learn's gradients
    params_after: Dict[int, List[torch.Tensor]]  # params after learn j (those asked for)
    target_after: Dict[int, List[torch.Tensor]]
    stage: Dict[int, dict]  # learn j (those asked for): rows drawn, networks before, loss, grads
    final_phase: torch.Tensor
    final_t: torch.Tensor
    act_gap: float  # widest gap of a judged greedy action below the best, relative
    greedy_rows: int
    explore_rows: int
    explore_mismatch: int


def simulate(spec: Spec, *, device, num_envs: int, steps_per_learn: int, chunks: int,
             call_seeds: Sequence[int], learn: bool, params0: Sequence[torch.Tensor],
             actions: Optional[torch.Tensor] = None, act_precision: str = "float32",
             learn_precision: str = "float32", keep_learns: Sequence[int] = (),
             stage_learns: Sequence[int] = (), print_vector: Optional[torch.Tensor] = None,
             lost: Optional[int] = None) -> Run:
    """Run the driver's calls (one dispatch of `chunks` x `steps_per_learn`
    vector steps each, a learn after each chunk when `learn`) from the seeds.
    `actions` (steps, B), the actions to judge, are taken as the agent's
    (teacher forcing); without them the agent acts by its own Q at
    `act_precision`. The judged greedy actions' gap below the best Q is
    measured at float32. `lost` replaces the replay's (history - 1) pushes
    left out after a wrap (a planted fault)."""
    B, A = num_envs, spec.num_actions
    params = [p.detach().clone().float() for p in params0]
    target = [p.clone() for p in params]
    opt = AdamW(spec, params)
    hist = History()
    losses, grads1 = [], None
    params_after, target_after, stage = {}, {}, {}
    act_gap, greedy_rows, explore_rows, mismatch = 0.0, 0, 0, 0
    phase = t = None
    step = 0
    with exact_float32():
        for seed in call_seeds:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            if phase is None:
                phase = torch.rand((B,), generator=gen, device=device) * 6.28
                t = torch.zeros((B,), dtype=torch.int32, device=device)
            for _ in range(chunks):
                for _ in range(steps_per_learn):
                    u = torch.rand((B, 1 + A), generator=gen, device=device)
                    explore = u[:, 0] < spec.epsilon
                    rand_idx = torch.argmax(u[:, 1:], dim=-1).to(torch.int32)
                    x = window(spec, phase, t)
                    q_ref = q_values(spec, params, x, "float32")
                    if actions is None:
                        q_own = q_ref if act_precision == "float32" else q_values(
                            spec, params, x, act_precision)
                        greedy = torch.argmax(q_own, dim=-1).to(torch.int32)
                        a = torch.where(explore, rand_idx, greedy)
                    else:
                        a = actions[step].to(device=device, dtype=torch.int32)
                    # Judge: explored rows must take the drawn action; greedy
                    # rows are measured against the best Q.
                    mismatch += int((explore & (a != rand_idx)).sum())
                    explore_rows += int(explore.sum())
                    keep = ~explore
                    greedy_rows += int(keep.sum())
                    if bool(keep.any()):
                        q_a = q_ref.gather(1, a.long()[:, None])[:, 0]
                        gap = q_ref.max(dim=-1).values - q_a
                        scale = q_ref.abs().amax(dim=-1).median().clamp(min=1e-30)
                        act_gap = max(act_gap, float((gap[keep] / scale).max()))
                    reward = torch.where(a == target_action(spec, phase, t), 1.0, 0.0)
                    t_next = t + 1
                    truncated = t_next >= spec.episode_len
                    hist.phase.append(phase)
                    hist.t.append(t)
                    hist.action.append(a)
                    hist.reward.append(reward)
                    hist.truncated.append(truncated)
                    if print_vector is not None:
                        hist.print_s.append(frame_print(x[:, -1], print_vector))
                        p_t = torch.zeros((B,), dtype=torch.float64, device=device)
                        if bool(truncated.any()):
                            p_t[truncated] = frame_print(
                                frames(spec, phase[truncated], t_next[truncated]), print_vector)
                        hist.print_t.append(p_t)
                    fresh = torch.rand((B,), generator=gen, device=device) * 6.28
                    phase = torch.where(truncated, fresh, phase)
                    t = torch.where(truncated, torch.zeros_like(t_next), t_next)
                    step += 1
                if not learn:
                    continue
                oldest, n_valid = sample_range(spec, step, B, lost)
                q = torch.randint(0, n_valid, (spec.batch_size,), generator=gen, device=device)
                push, env = oldest + q // B, q % B
                batch = learn_batch_windows(spec, hist, push, env)
                j = opt.step_count + 1
                before = ([p.clone() for p in params], [p.clone() for p in target])
                loss, grads = td_step(spec, params, target, opt, batch, learn_precision)
                losses.append(loss)
                if j == 1:
                    grads1 = grads
                if j in keep_learns:
                    params_after[j] = [p.clone() for p in params]
                    target_after[j] = [p.clone() for p in target]
                if j in stage_learns:
                    stage[j] = {"push": push, "env": env, "params": before[0],
                                "target": before[1], "loss": loss, "grads": grads}
    return Run(hist=hist, losses=losses, grads1=grads1, params_after=params_after,
               target_after=target_after, stage=stage, final_phase=phase, final_t=t,
               act_gap=act_gap, greedy_rows=greedy_rows, explore_rows=explore_rows,
               explore_mismatch=mismatch)


# -------------------------------------------------------------- comparison
CHECKS = ("act_gap", "explore_mismatch", "rows_mismatch", "frame_gap", "frame_print_gap")
LEARN_CHECKS = ("loss_gap", "grad_gap", "delta_gap", "target_gap", "wrap_loss_gap",
                "wrap_grad_gap")


def judged_learns(spec: Spec, traffic: dict, dispatches: int):
    """(learns whose networks after them are compared, learns judged as a
    stage from the program's networks before them) over `dispatches`
    dispatches: the 3rd and the first target update; and the first and the
    last learn of the last dispatch that sample a wrapped replay."""
    if not traffic["learn"]:
        return (), ()
    k, chunks = traffic["learn_every_k_steps"], traffic["chunks_per_dispatch"]
    cap = spec.capacity // traffic["num_envs"]
    last = range((dispatches - 1) * chunks + 1, dispatches * chunks + 1)
    wrapped = [j for j in last if j * k > cap]
    return (3, spec.target_update_freq), tuple(sorted({wrapped[0], wrapped[-1]}))


def checks(learn: bool) -> tuple:
    """The numbers `judge` returns for a training (learn) or a collection mix."""
    return CHECKS + (LEARN_CHECKS if learn else ())


def judge(spec: Spec, traffic: dict, call_seeds: Sequence[int], print_seed: int, prog: dict,
          init: Sequence[torch.Tensor], device, detail: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared.

    `prog` holds the program's outputs of the dispatches of `call_seeds`:
    `actions` (pushes, B) in push order; `rows`, replay rows read back
    (`push` (N,), `action`, `reward`, `truncated`, `terminated`, `print_s`,
    `print_t` (N, B), `seq` (N,)); `frames`, the acting (`frame_s`) and
    truncation (`frame_t`) frames (pushes, S, F) of the envs `envs`;
    `window` (B, T, F), every env's acting window after the last dispatch;
    `env`, every env's `phase` and `t` then; for training, `losses` of the
    first learns, `grads1`, `params` and `target` after the learns kept, and
    `stage`, the learns judged from the program's own networks before them
    (`judged_learns`). The reference runs the same seeds with the program's
    actions taken as the agent's; `init` are the weights both started from.
    `detail`, when given, receives each learn's and leaf's gaps.

    - `act_gap`: the widest gap by which a greedy action's reference Q lies
      below the reference's best Q of its row, over every greedy row of
      every push, relative to the step's median largest |Q|;
    - `explore_mismatch`: explored rows whose action is not the drawn one;
    - `rows_mismatch`: replay rows read back whose reward, truncation,
      termination or sequence tag differ from the reference's (each push
      read once after its own dispatch, and every push resident after the
      last, those written over the wrap included), and envs whose (phase,
      step) after the last dispatch differ;
    - `frame_print_gap`: the largest gap of a frame's print (`frame_print`)
      over every replay row of every env: its acting frame, and a truncated
      row's final frame in the side ring;
    - `frame_gap`: the largest |difference| of a frame element: the acting
      and truncation frames of the sampled envs' rows, and every env's live
      window after the last dispatch;
    - training only, over the first learns: `loss_gap`, the largest
      relative gap of a learn's mean |TD error| over the first three;
      `grad_gap`, the worst leaf's gap of the first gradient's norm;
      `delta_gap`, the worst leaf's gap of the norm of the change after
      three learns. A leaf's gap is |norm_program - norm_reference| over
      the larger of the reference's norm of that leaf and of the median
      leaf. Leaves whose reference gradient is under a thousandth of the
      median leaf's move by round-off alone and are left out of the change;
    - training only, as stages from the program's own state: `target_gap`,
      the worst leaf's norm of the program's target after its first soft
      update less t0 + tau (p - t0), where p is the program's online
      network after that learn and t0 the weights both started from, over
      the larger of that leaf's and the median leaf's norm of tau (p - t0);
      `wrap_loss_gap` and `wrap_grad_gap`, the relative gap of the mean
      |TD error| and the worst leaf's gap of the gradient's norm of the
      learns after the replay has wrapped, the reference drawing the rows
      by its own range and rebuilding them from its own history, from the
      program's networks before each learn. The reference's own learns
      are followed over the first three only: after those, Adam turns the
      round-off of near-zero gradient elements into whole steps of the
      learning rate, so a followed network drifts from the program's by
      more than a learn's own error.
    """
    learn = traffic["learn"]
    B = traffic["num_envs"]
    dev = prog["window"].device
    vector = print_vector(print_seed, spec.height * spec.width, dev)
    ref = simulate(
        spec, device=device, num_envs=B, steps_per_learn=traffic["learn_every_k_steps"],
        chunks=traffic["chunks_per_dispatch"], call_seeds=call_seeds, learn=learn,
        params0=init, actions=prog["actions"], keep_learns=tuple(prog.get("params", ())),
        stage_learns=tuple(prog.get("stage", ())), print_vector=vector,
    )
    out: Dict[str, float] = {
        "act_gap": ref.act_gap,
        "explore_mismatch": float(ref.explore_mismatch),
    }

    rows = prog["rows"]
    push = rows["push"].to(dev)
    hist = {name: torch.stack(getattr(ref.hist, name)).to(dev)[push]
            for name in ("reward", "truncated", "print_s", "print_t")}
    mism = int((rows["reward"] != hist["reward"]).sum())
    mism += int((rows["truncated"] != hist["truncated"]).sum())
    mism += int(rows["terminated"].sum())
    mism += int((rows["seq"].long() != push).sum())
    mism += int((prog["env"]["t"].to(dev) != ref.final_t.to(dev)).sum())
    mism += int((prog["env"]["phase"].to(dev) != ref.final_phase.to(dev)).sum())
    out["rows_mismatch"] = float(mism)

    both = rows["truncated"] & hist["truncated"]
    print_gap = float((rows["print_s"] - hist["print_s"]).abs().max())
    if bool(both.any()):
        print_gap = max(print_gap, float((rows["print_t"] - hist["print_t"])[both].abs().max()))
    out["frame_print_gap"] = print_gap

    envs = prog["envs"].to(dev)
    n = prog["frames"]["frame_s"].shape[0]
    phase = torch.stack(ref.hist.phase[:n]).to(dev)[:, envs]
    t = torch.stack(ref.hist.t[:n]).to(dev)[:, envs]
    trunc_all = torch.stack(ref.hist.truncated[:n]).to(dev)[:, envs]
    gap = 0.0
    for p in range(n):
        want_s = frames(spec, phase[p], t[p]).flatten(1)
        gap = max(gap, float((prog["frames"]["frame_s"][p].float() - want_s).abs().max()))
        trunc = trunc_all[p]
        if bool(trunc.any()):
            want_t = frames(spec, phase[p][trunc], t[p][trunc] + 1).flatten(1)
            got_t = prog["frames"]["frame_t"][p][trunc].float()
            gap = max(gap, float((got_t - want_t).abs().max()))
    final_phase, final_t = ref.final_phase.to(dev), ref.final_t.to(dev)
    for lo in range(0, B, 512):
        live = window(spec, final_phase[lo:lo + 512], final_t[lo:lo + 512]).flatten(2)
        gap = max(gap, float((prog["window"][lo:lo + 512].float() - live).abs().max()))
    out["frame_gap"] = gap

    if learn:
        losses_p = [float(x) for x in prog["losses"]]
        losses_r = [float(x) for x in ref.losses[: len(losses_p)]]
        out["loss_gap"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_p, losses_r))
        grads = leaf_gaps(prog["grads1"], [g.to(dev) for g in ref.grads1])
        kd = min(prog["params"])
        d_prog = [p - i for p, i in zip(prog["params"][kd], init)]
        d_ref = [p.to(dev) - i for p, i in zip(ref.params_after[kd], init)]
        deltas = leaf_gaps(d_prog, d_ref, moved_leaves(ref.grads1))
        kt = spec.target_update_freq
        step = [spec.tau * (p - i) for p, i in zip(prog["params"][kt], init)]
        step_n = [float(s_.double().norm()) for s_ in step]
        floor = statistics.median(step_n)
        targets = [float((t_ - i - s_).double().norm()) / max(n_, floor, 1e-30)
                   for t_, i, s_, n_ in zip(prog["target"][kt], init, step, step_n)]
        out["grad_gap"], out["delta_gap"], out["target_gap"] = (
            worst(grads), worst(deltas), worst(targets))
        wrap_loss, wrap_grads = [], []
        with exact_float32():
            for j, got in sorted(prog["stage"].items()):
                drawn = ref.stage[j]
                batch = learn_batch_windows(spec, ref.hist, drawn["push"], drawn["env"])
                loss_r, grads_r = td_grad(spec, [p.to(device) for p in got["params"]],
                                          [p.to(device) for p in got["target"]], batch)
                wrap_loss.append(abs(float(got["loss"]) - float(loss_r))
                                 / max(abs(float(loss_r)), 1e-30))
                wrap_grads.append(worst(leaf_gaps(got["grads"], [g.to(dev) for g in grads_r])))
        out["wrap_loss_gap"], out["wrap_grad_gap"] = max(wrap_loss), max(wrap_grads)
        if detail is not None:
            detail.update(losses=list(zip(losses_p, losses_r)), grad=grads, delta=deltas,
                          target=targets, wrap_loss=wrap_loss, wrap_grad=wrap_grads)
    return out


# ------------------------------------------------------------ the control
LOWER = {"bfloat16": "fp8", "float16": "fp8", "float32": "tf32"}
LOWER_DTYPE = {torch.bfloat16: torch.float8_e4m3fn, torch.float16: torch.float8_e4m3fn,
               torch.float32: torch.bfloat16}
FAULTS = ("none", "half_batch", "altered_action", "wrap_range")


def stand_in(spec: Spec, config: dict, traffic: dict, call_seeds: Sequence[int],
             print_seed: int, init: Sequence[torch.Tensor], device, envs: torch.Tensor,
             keep_learns: Sequence[int], stage_learns: Sequence[int],
             fault: str = "none") -> dict:
    """The reference put in the program's place: its outputs of the calls
    `call_seeds`, in the form `judge` reads of the program. With `fault`
    "none" it is the control, one precision below the configuration's (the
    act in fp8 for bfloat16, the learn in TF32 for float32 with TF32 off,
    the frames one dtype below); otherwise it runs at the configuration's
    precision with a fault planted: "half_batch" (each learn on half its
    rows), "altered_action" (one env's action of each step changed after it
    was taken), "wrap_range" (after the replay wraps, the draws reach into
    the oldest pushes, whose windows have lost frames)."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    learn = traffic["learn"]
    common = dict(device=device, num_envs=traffic["num_envs"],
                  steps_per_learn=traffic["learn_every_k_steps"],
                  chunks=traffic["chunks_per_dispatch"], call_seeds=call_seeds, learn=learn,
                  params0=init, keep_learns=keep_learns, stage_learns=stage_learns,
                  print_vector=print_vector(print_seed, spec.height * spec.width, device))
    precision = config["precision"]
    global td_grad
    full_grad = td_grad
    if fault == "none":
        spec = dataclasses.replace(spec, obs_dtype=LOWER_DTYPE[spec.obs_dtype])
        run = simulate(spec, act_precision=LOWER[precision["act"]],
                       learn_precision=LOWER[precision["learn"]], **common)
    elif fault == "half_batch":
        td_grad = lambda spec_, params, target, batch, prec="float32": full_grad(  # noqa: E731
            spec_, params, target, tuple(x[: x.shape[0] // 2] for x in batch), prec)
        try:
            run = simulate(spec, act_precision=precision["act"], **common)
        finally:
            td_grad = full_grad
    else:
        run = simulate(spec, act_precision=precision["act"],
                       lost=0 if fault == "wrap_range" else None, **common)
        if fault == "altered_action":
            for a in run.hist.action:
                a[0] = (a[0] + 1) % spec.num_actions
    h = run.hist
    n = len(h.reward)
    trunc = torch.stack(h.truncated)
    phase, t = torch.stack(h.phase)[:, envs], torch.stack(h.t)[:, envs]
    frame_s = torch.stack([frames(spec, phase[p], t[p]).flatten(1) for p in range(n)])
    frame_t = torch.stack([frames(spec, phase[p], t[p] + 1).flatten(1) * trunc[p, envs, None]
                           for p in range(n)])
    actions = torch.stack(h.action)
    out = {
        "actions": actions,
        "rows": {
            "push": torch.arange(n, device=actions.device), "action": actions,
            "reward": torch.stack(h.reward), "truncated": trunc,
            "terminated": torch.zeros_like(trunc),
            "seq": torch.arange(n, device=actions.device, dtype=torch.int32),
            "print_s": torch.stack(h.print_s), "print_t": torch.stack(h.print_t),
        },
        "frames": {"frame_s": frame_s, "frame_t": frame_t},
        "window": window(spec, run.final_phase, run.final_t).flatten(2),
        "env": {"phase": run.final_phase, "t": run.final_t},
        "envs": envs,
    }
    if learn:
        out.update(losses=run.losses[:3], grads1=run.grads1,
                   params={k: run.params_after[k] for k in keep_learns},
                   target={k: run.target_after[k] for k in keep_learns},
                   stage={j: {k: v for k, v in run.stage[j].items() if k not in ("push", "env")}
                          for j in stage_learns})
    return out
