"""Q-value networks (port of `pearl_tpu/neural_networks/q_value_networks.py`:
`VanillaQValueNetwork`, `MultiHeadQValueNetwork`, `DuelingQValueNetwork`,
`TwoTowerQValueNetwork`, `QuantileQValueNetwork`, `EnsembleQValueNetwork` and
`CNNQValueNetwork` with its two act branches, the conv1 cache (opt-in) and
the ring conv (the card's default on bfloat16 rings)).

Each network is a frozen-dataclass adapter over an `nn.Module`, with the
reference's protocol:

    init(generator, state_dim, action_dim, num_actions) -> nn.Module (params)
    q_all(params, state (B, s), actions (B, A, a), mask) -> (B, A)

`generator` is a CPU `torch.Generator` for the weight init; move the module
to its device afterwards. The quantile network adds
`quantiles_all(params, state, actions, mask) -> (B, A, N)`, the ensemble
`q_ensemble(params, state, actions, mask) -> (B, K, A)`; the ensemble's
params are a dict {"train", "prior"} of two modules (see its docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pearl_tpu_torch.neural_networks.common import MLP, ConvNet, nchw_images, over_actions
from pearl_tpu_torch.neural_networks.twin_critic import StackedPairQNet
from pearl_tpu_torch.ops.conv_cache import cache_write, gather_sum
from pearl_tpu_torch.ops.fused_mlp import fused_mlp_from_module
from pearl_tpu_torch.ops.layout_fence import copy_fence, masked_scale_fence, masked_scale_fence4
from pearl_tpu_torch.ops.ring_conv import ring_conv1, ring_conv_applicable


class _PairQNet(nn.Module):
    """MLP over concat(state, action) -> (N, output_dim) (flax `_PairQNet`),
    with layer norm in its hidden layers under `use_layer_norm`."""

    def __init__(self, state_dim, action_dim, hidden_dims, generator=None, output_dim=1,
                 use_layer_norm=False):
        super().__init__()
        self.MLP_0 = MLP(state_dim + action_dim, hidden_dims, output_dim, generator=generator,
                         use_layer_norm=use_layer_norm)

    def forward(self, state, action):
        return self.MLP_0(torch.cat([state, action], dim=-1))


class _MultiHeadNet(nn.Module):
    """state -> one Q head per action (flax `_MultiHeadNet`)."""

    def __init__(self, state_dim, hidden_dims, num_actions, generator=None):
        super().__init__()
        self.MLP_0 = MLP(state_dim, hidden_dims, num_actions, generator=generator)

    def forward(self, state):
        return self.MLP_0(state)


@dataclasses.dataclass(frozen=True)
class VanillaQValueNetwork:
    """Q(s, a) via a concat-MLP evaluated over every candidate action."""

    hidden_dims: Sequence[int] = (64, 64)
    use_layer_norm: bool = False

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        return _PairQNet(state_dim, action_dim, tuple(self.hidden_dims), generator,
                         use_layer_norm=self.use_layer_norm)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        return over_actions(params, state, actions)[..., 0]


@dataclasses.dataclass(frozen=True)
class MultiHeadQValueNetwork:
    """state -> one Q head per action. Ignores the action representation;
    candidate order is head order.

    `q_all` always runs the MLP through `ops.fused_mlp`: the hand-written
    kernel for a CUDA tensor, the plain chain for a CPU tensor. (The
    reference's environment-variable gate rests on a TPU measurement and is
    not carried over.)"""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del action_dim
        return _MultiHeadNet(state_dim, tuple(self.hidden_dims), num_actions, generator)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        return fused_mlp_from_module(params.MLP_0, state)


class _DuelingNet(nn.Module):
    """Dueling architecture (flax `_DuelingNet`): a shared state trunk, a
    value head V(s) and an advantage head A(s, a) over concat(features,
    action) for every candidate; Q = V + A - mean of A over the available
    actions."""

    def __init__(self, state_dim, action_dim, hidden_dims, generator=None):
        super().__init__()
        width = hidden_dims[-1]
        self.state_arch = MLP(
            state_dim, hidden_dims[:-1], width, generator=generator, last_activation="relu"
        )
        self.value_arch = MLP(width, (width,), 1, generator=generator)
        self.advantage_arch = MLP(width + action_dim, (width,), 1, generator=generator)

    def forward(self, state, actions, mask=None):
        B, A = actions.shape[0], actions.shape[1]
        feat = self.state_arch(state)
        value = self.value_arch(feat)[..., 0]
        adv_in = torch.cat([feat[:, None, :].expand(B, A, feat.shape[-1]), actions], dim=-1)
        adv = self.advantage_arch(adv_in.reshape(B * A, -1)).reshape(B, A)
        if mask is None:
            adv_mean = adv.mean(dim=-1, keepdim=True)
        else:
            m = mask.to(adv.dtype)
            adv_mean = (adv * m).sum(dim=-1, keepdim=True) / torch.clamp(
                m.sum(dim=-1, keepdim=True), min=1.0
            )
        return value[:, None] + adv - adv_mean


@dataclasses.dataclass(frozen=True)
class DuelingQValueNetwork:
    """Dueling Q: a plain PyTorch product, as the reference computes it
    outside any TPU kernel."""

    hidden_dims: Sequence[int] = (64, 64)

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        return _DuelingNet(state_dim, action_dim, tuple(self.hidden_dims), generator)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        return params(state, actions, mask)


class _TwoTowerNet(nn.Module):
    """A state tower and an action tower (relu on their last layers too),
    concatenated into the interaction MLP (flax `_TwoTowerNet`:
    `state_tower`, `action_tower`, `interaction`)."""

    def __init__(self, state_dim, action_dim, state_hidden_dims, action_hidden_dims,
                 hidden_dims, state_output_dim, action_output_dim, generator=None):
        super().__init__()
        self.state_tower = MLP(state_dim, state_hidden_dims, state_output_dim,
                               generator=generator, last_activation="relu")
        self.action_tower = MLP(action_dim, action_hidden_dims, action_output_dim,
                                generator=generator, last_activation="relu")
        self.interaction = MLP(state_output_dim + action_output_dim, hidden_dims, 1,
                               generator=generator)

    def forward(self, state, actions):
        """state (B, s), actions (B, A, a) -> (B, A). The state tower runs
        once per state, not once per (state, action) pair: the same rows as
        the reference's, which evaluates it B * A times."""
        B, A = actions.shape[0], actions.shape[1]
        s = self.state_tower(state)
        a = self.action_tower(actions.reshape(B * A, -1)).reshape(B, A, -1)
        x = torch.cat([s[:, None, :].expand(B, A, s.shape[-1]), a], dim=-1)
        return self.interaction(x.reshape(B * A, -1)).reshape(B, A)


@dataclasses.dataclass(frozen=True)
class TwoTowerQValueNetwork:
    """Two-tower Q: a plain PyTorch product, as the reference computes it
    outside any TPU kernel."""

    state_hidden_dims: Sequence[int] = (64,)
    action_hidden_dims: Sequence[int] = (64,)
    hidden_dims: Sequence[int] = (64, 64)
    state_output_dim: int = 64
    action_output_dim: int = 64

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        return _TwoTowerNet(
            state_dim, action_dim, tuple(self.state_hidden_dims), tuple(self.action_hidden_dims),
            tuple(self.hidden_dims), self.state_output_dim, self.action_output_dim, generator,
        )

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        return params(state, actions)


@dataclasses.dataclass(frozen=True)
class QuantileQValueNetwork:
    """Quantile-distributional Q: a concat-MLP with `num_quantiles` outputs
    over every candidate. `taus` are the N + 1 quantile edges, `midpoints`
    the N midpoints the QR loss weights with."""

    hidden_dims: Sequence[int] = (64, 64)
    num_quantiles: int = 10
    use_layer_norm: bool = False

    def taus(self, device=None) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, self.num_quantiles + 1, device=device)

    def midpoints(self, device=None) -> torch.Tensor:
        t = self.taus(device)
        return (t[:-1] + t[1:]) / 2.0

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        return _PairQNet(
            state_dim, action_dim, tuple(self.hidden_dims), generator, self.num_quantiles,
            use_layer_norm=self.use_layer_norm,
        )

    def quantiles_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        """(B, A, N) quantile values of every candidate action."""
        return over_actions(params, state, actions)

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        """The risk-neutral Q: the mean over quantiles."""
        return self.quantiles_all(params, state, actions, mask).mean(dim=-1)


@dataclasses.dataclass(frozen=True)
class EnsembleQValueNetwork:
    """K concat-MLP Q-networks, each plus a frozen random prior scaled by
    `prior_scale` (the reference's `_PriorQNet` members over `Ensemble`).

    `init` returns a dict {"train": StackedPairQNet, "prior":
    StackedPairQNet} (move each to its device): the K members stacked (kernels (K, in, out)),
    all K evaluated as one batched product per layer, as the twin critic's
    two. The prior's parameters have `requires_grad=False`, and a learner
    hands only "train" to its optimizer and to its target copy
    (`BootstrappedDQN` keeps the prior in its state apart from `params`), so
    neither weight decay nor a target update reaches it. `q_ensemble` takes
    any mapping with those two keys."""

    hidden_dims: Sequence[int] = (64, 64)
    ensemble_size: int = 10
    prior_scale: float = 0.3

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del num_actions
        K, hidden = self.ensemble_size, tuple(self.hidden_dims)
        train = StackedPairQNet(K, state_dim, action_dim, hidden, generator)
        prior = StackedPairQNet(K, state_dim, action_dim, hidden, generator)
        return {"train": train, "prior": prior.requires_grad_(False)}

    def q_ensemble(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        """(B, K, A): every member's Q of every candidate action; no gradient
        reaches the prior."""
        B, A = actions.shape[0], actions.shape[1]
        s = state[:, None, :].expand(B, A, state.shape[-1]).reshape(B * A, -1)
        a = actions.reshape(B * A, -1)
        q = params["train"](s, a)
        with torch.no_grad():
            prior = params["prior"](s, a)
        q = q + self.prior_scale * prior  # (K, B*A)
        return q.reshape(-1, B, A).transpose(0, 1)

    def q_member(self, params, state, actions, z, mask: Optional[torch.Tensor] = None):
        """(B, A): Q under each row's member index z (B,)."""
        q = self.q_ensemble(params, state, actions, mask)
        return q.gather(1, z.long()[:, None, None].expand(-1, 1, q.shape[-1]))[:, 0]

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        """The ensemble mean (acting without deep exploration)."""
        return self.q_ensemble(params, state, actions, mask).mean(dim=1)


class _CNNQNet(nn.Module):
    """Conv stack then an MLP with one Q head per action (flax `_CNNQNet`:
    `conv` with `conv_i`, then `MLP_0`)."""

    def __init__(
        self, input_shape, out_channels, kernel_sizes, strides, paddings, hidden_dims,
        num_actions, generator=None,
    ):
        super().__init__()
        H, W, C = input_shape
        self.conv = ConvNet(C, out_channels, kernel_sizes, strides, paddings, generator=generator)
        for k, s, p in zip(kernel_sizes, strides, paddings):
            H, W = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
        self.feature_shape = (out_channels[-1], H, W)  # (C, H, W), the flatten's order
        self.MLP_0 = MLP(out_channels[-1] * H * W, hidden_dims, num_actions, generator=generator)

    def forward(self, images):
        """images: NCHW in [0, 255]."""
        return self.MLP_0(self.conv(images))


def act_takes_ring_conv(
    ring_conv: Optional[bool], fits: bool, dtype: torch.dtype, device_type: str,
) -> bool:
    """Whether `CNNQValueNetwork`'s live acting window runs conv1 through the
    ring conv (kernel B5): as `ring_conv` says when it is set, and under its
    default None where conv1's geometry `fits` the kernel (the check that
    `ring_conv=True` makes) and the ring is a bfloat16 tensor on a CUDA
    device. Reads no tensor, so the choice costs no host sync."""
    if ring_conv is not None:
        return ring_conv
    return fits and device_type == "cuda" and dtype == torch.bfloat16


@dataclasses.dataclass(frozen=True)
class CNNQValueNetwork:
    """Atari-style CNN multi-head Q. `state` is a flattened (H, W, C) image
    batch or, with `time_major_stack`, a flattened time-major frame window
    (T, H, W, frame_channels) whose frames become the channels t*fc + c; or a
    `FrameRingView`, read in ring order without materialising the window
    (`_q_all_ring`). The reference computes in NHWC; the images are the same
    and are handed to `conv2d` as NCHW.

    The convolutions and the MLP tail are outside every TPU kernel in the
    reference and are `conv2d` / `linear` here. The ring path's masking and
    normalising pass runs through the hand-written fences of
    `ops/layout_fence.py` (the reference's environment-variable gate rests on
    a TPU measurement and is not carried over).

    Two branches take conv1 of the window off the ACT path; the learn path's
    replay windows (`from_replay=True`) always keep the fences:
    - `conv1_cache=True` (with `time_major_stack`, opt-in): conv1 becomes a
      masked sum over a cache of per-frame contributions
      (`ops/conv_cache.py`). Needs `frame_channels == 1` and
      `paddings[0] == 0`, and a `PearlAgent`, which owns the cache: seeded at
      `init`, one `cache_write` per observe, a full `refresh_cache` after
      every learn. The cached Q agrees with the direct Q up to the grouping of
      a float32 sum, not bit for bit.
    - the ring conv: mask, /255, conv1, bias and relu in the one hand-written
      kernel of `ops/ring_conv.py` (B5). `ring_conv` chooses it:
      - None (the default): wherever it applies, which is decided by
        `act_takes_ring_conv` from the conv1 geometry (once, at
        construction; one the kernel does not take quietly keeps the fences)
        and the ring's dtype and device (a bfloat16 CUDA ring). A CPU or a
        float32 ring keeps the fences, so the CPU computes what it always
        has.
      - True (the reference's `PEARL_TPU_RING_CONV=1`): on every ring, the
        CPU's included (the plain version there). A geometry the kernel does
        not take is a ValueError at construction, never a quiet change of
        branch.
      - False: never; the fences, `conv2d` and relu, the library's conv1.
      True and False are for the tests and the card's smoke checks, which
      hold the two paths against each other; no configuration needs them.
      One geometry check serves all three values, so the default takes B5
      exactly where True would not raise.
      The reference keeps the ring conv opt-in until it is measured faster
      on its chip. On an H100 it is 13.5x faster than what it replaces on
      the act path (0.0416 against 0.5626 ms at 1024 envs, 84x84x4): cuDNN
      has no bfloat16 tensor-core kernel for four input channels, converts
      the window and runs conv1 in float32.
    With both the cache and the ring conv the cache comes first, as in the
    reference."""

    input_shape: Tuple[int, int, int] = (84, 84, 4)  # (H, W, C)
    out_channels: Sequence[int] = (16, 32)
    kernel_sizes: Sequence[int] = (8, 4)
    strides: Sequence[int] = (4, 2)
    paddings: Sequence[int] = (0, 0)
    hidden_dims: Sequence[int] = (128,)
    time_major_stack: bool = False
    frame_channels: int = 1
    conv1_cache: bool = False
    ring_conv: Optional[bool] = None

    def __post_init__(self):
        self.cache_enabled  # raises on a configuration the cache does not take
        T, H, W, k, s, _, _, OC = self._conv1_dims()
        # Whether B5 takes conv1, checked once for every value of `ring_conv`:
        # at float32's 4 bytes an element, which fits a ring of either dtype.
        fits = self.time_major_stack and ring_conv_applicable(
            T, H, W, self.frame_channels, k, s, self.paddings[0], OC)
        object.__setattr__(self, "_ring_conv_fits", fits)
        if self.ring_conv and not fits:
            if not self.time_major_stack:
                raise ValueError(
                    "ring_conv=True requires time_major_stack=True (the ring axis is the "
                    "frame-stack axis)"
                )
            raise ValueError(
                f"ring_conv=True does not take this conv1 (T={T}, {H}x{W} frames of "
                f"{self.frame_channels} channels, k={k}, s={s}, padding "
                f"{self.paddings[0]}, {OC} output channels): see "
                "ops.ring_conv.ring_conv_applicable"
            )

    @property
    def supports_frame_ring(self) -> bool:
        """Ring-aware marker: this net consumes a `FrameRingView` directly;
        `PearlAgent` requires it of a frame-ring summarizer's network."""
        return self.time_major_stack

    def init(self, generator, state_dim: int, action_dim: int, num_actions: int):
        del state_dim, action_dim  # the flattened state is reshaped to input_shape
        return _CNNQNet(
            tuple(self.input_shape), tuple(self.out_channels), tuple(self.kernel_sizes),
            tuple(self.strides), tuple(self.paddings), tuple(self.hidden_dims), num_actions,
            generator,
        )

    def q_all(self, params, state, actions, mask: Optional[torch.Tensor] = None):
        if not isinstance(state, torch.Tensor) and hasattr(state, "ring"):
            return self._q_all_ring(params, state)
        H, W, C = self.input_shape
        B = state.shape[0]
        if self.time_major_stack:
            fc = self.frame_channels
            images = state.reshape(B, C // fc, H, W, fc).permute(0, 1, 4, 2, 3).reshape(B, C, H, W)
        else:
            images = nchw_images(state, self.input_shape)
        return params(images)

    # ------------------------------------------------ conv1-cache act path
    def _conv1_dims(self):
        H, W, C = self.input_shape
        T = C // self.frame_channels
        k, s, p = self.kernel_sizes[0], self.strides[0], self.paddings[0]
        OH = (H + 2 * p - k) // s + 1
        OW = (W + 2 * p - k) // s + 1
        return T, H, W, k, s, OH, OW, self.out_channels[0]

    @property
    def cache_enabled(self) -> bool:
        if not (self.conv1_cache and self.time_major_stack):
            return False
        if self.frame_channels != 1 or self.paddings[0] != 0:
            raise ValueError("conv1_cache requires frame_channels == 1 and paddings[0] == 0")
        return True

    def cache_dim(self) -> int:
        T, _, _, _, _, OH, OW, OC = self._conv1_dims()
        return T * OH * OW * OC

    def _k64(self, params, dtype):
        """conv1's kernel (OC, T, k, k) in position-major single-input-channel
        form (T*OC, 1, k, k), channel index p*OC + oc, cast to `dtype` and
        then divided by 255: the input normalisation folded in
        (conv(x/255, W) == conv(x, W/255))."""
        T, _, _, k, _, _, _, OC = self._conv1_dims()
        params.conv.check_plain_relu_stack()
        k0 = params.conv.conv_0.weight.to(dtype) / 255.0
        return k0.permute(1, 0, 2, 3).reshape(T * OC, 1, k, k)

    def cache_contrib_y(self, params, entry):
        """The new frame's contrib conv output (B, T*OC, OH, OW) from the
        contiguous (B, F) ring entry."""
        _, H, W, _, _, _, _, _ = self._conv1_dims()
        return self._contrib_conv(params, entry.reshape(entry.shape[0], 1, H, W))

    def _contrib_conv(self, params, frames):
        """(N, 1, H, W) frames -> (N, T*OC, OH, OW) conv1 contributions under
        all T position kernels (before bias and relu), channel index
        p*OC + oc. One `conv2d`: the reference computes it with XLA's
        convolution, outside any kernel."""
        _, _, _, _, s, _, _, _ = self._conv1_dims()
        return F.conv2d(frames, self._k64(params, frames.dtype), stride=s).contiguous()

    @torch.no_grad()
    def refresh_cache(self, params, view):
        """Recompute the whole (T, P, B, D) diagonal cache from the ring, with
        `params`' conv1 weights cast to the ring's dtype: the agent calls it
        at `init` and after every learn step. Per ring slot: the frame copied
        out of the ring (`copy_fence`), one single-frame conv, then the same
        diagonal write the per-step path makes (`cache_write` with cursor ==
        slot). The cache is allocated once, zeroed, in the ring's dtype, and
        rewritten IN PLACE afterwards: the returned tensor is `view.cache`
        when there was one."""
        T, H, W, _, _, OH, OW, OC = self._conv1_dims()
        ring = view.ring
        B = ring.shape[0]
        cache = view.cache
        if cache is None:
            cache = torch.zeros((T, T, B, OC * OH * OW), dtype=ring.dtype, device=ring.device)
        for slot in range(T):
            frame = copy_fence(ring[:, slot])
            y = self._contrib_conv(params, frame.reshape(B, 1, H, W))
            cache_write(cache, y, slot, T=T, OC=OC)
        return cache

    def _q_all_cached(self, params, view):
        """Act-path Q from the contribution cache: conv1 of the window as a
        one-slab masked sum (`ops.conv_cache.gather_sum`), bias and relu in
        float32, then the conv and MLP tail. Nothing here reads the ring."""
        _, _, _, _, _, OH, OW, OC = self._conv1_dims()
        B = view.ring.shape[0]
        acc = gather_sum(view.cache, view.valid, view.cursor)  # (B, D) float32
        b0 = params.conv.conv_0.bias.to(torch.float32)
        y = F.relu(acc.reshape(B, OC, OH, OW) + b0[None, :, None, None])
        return self._conv_tail(params, y.to(view.ring.dtype))

    def _conv_tail(self, params, y):
        """conv_1 ... on `y` with weights cast to `y`'s dtype, then the MLP
        (in the promoted dtype of features and weights)."""
        for layer in params.conv.layers()[1:]:
            y = F.relu(
                F.conv2d(
                    y, layer.weight.to(y.dtype), layer.bias.to(y.dtype),
                    stride=layer.stride, padding=layer.padding,
                )
            )
        return params.MLP_0(y.flatten(1))

    def _q_all_ring(self, params, view):
        """Consume a `FrameRingView` without materialising the time-ordered
        stack: conv1's input channels are the T frames, so rolling its kernel
        by the ring cursor equals rolling the input into time order, and the
        fence masks invalid frames and normalises as conv1's input is made
        (so the conv stack must be the plain relu one over `/ 255` inputs:
        any other raises). The live acting carry (`from_replay` false)
        takes the conv1 cache when the view carries one, else the ring conv
        where `act_takes_ring_conv` says so."""
        if not self.time_major_stack:
            raise ValueError(
                "FrameRingView input requires time_major_stack=True (the ring "
                "axis is the frame-stack axis)"
            )
        params.conv.check_plain_relu_stack()
        if view.cache is not None and not view.from_replay and self.cache_enabled:
            return self._q_all_cached(params, view)
        H, W, C = self.input_shape
        fc = self.frame_channels
        T = C // fc
        ring, valid, cursor = view.ring, view.valid, view.cursor
        B = ring.shape[0]
        conv0 = params.conv.conv_0
        k0 = conv0.weight.to(ring.dtype)
        b0 = conv0.bias.to(ring.dtype)
        # Time order t -> ring slot (cursor + t) % T, so
        # W_ring[s] = W_time[(s - cursor) % T]  <=>  roll(W_time, cursor).
        if cursor:
            k0 = torch.roll(k0, cursor * fc, dims=1)
        if not view.from_replay and act_takes_ring_conv(
                self.ring_conv, self._ring_conv_fits, ring.dtype, ring.device.type):
            # The /255 goes into the weights (conv(x/255, W) == conv(x, W/255)),
            # flattened in the kernel's (t, ky, kx) order.
            k = self.kernel_sizes[0]
            wmat = (k0 / 255.0).permute(1, 2, 3, 0).reshape(T * k * k, -1)
            y = ring_conv1(ring, valid, wmat, b0, H=H, W=W, k=k, s=self.strides[0])
            return self._conv_tail(params, y)
        if fc == 1:
            inp = masked_scale_fence4(ring, valid, H=H, W=W, div=255.0)  # NCHW, C = T
        else:
            x = masked_scale_fence(ring, valid, div=255.0)
            inp = x.reshape(B, T, H, W, fc).permute(0, 1, 4, 2, 3).reshape(B, C, H, W)
        y = F.relu(F.conv2d(inp, k0, b0, stride=conv0.stride, padding=conv0.padding))
        return self._conv_tail(params, y)
