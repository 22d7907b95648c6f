"""Offline learning and evaluation (port of `pearl_tpu/training/offline.py`).

A dataset is columnar arrays loaded into a device replay buffer in one push;
training is N x {uniform sample -> agent.learn_batch} from one device
generator, in chunks of `log_every` batches; evaluation is the greedy,
non-learning driver.

Files: a columnar `.npz` (the field names of `TransitionBatch`, fields that
are None left out; the JAX package writes and reads the same files) or the
reference Pearl's `.pt`, a torch-saved list of transition dicts. A path with
"://" is fetched through urllib to a temporary file first.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pearl_tpu_torch.agent.pearl_agent import AgentState, PearlAgent
from pearl_tpu_torch.replay_buffers.replay_buffer import BasicReplayBuffer
from pearl_tpu_torch.replay_buffers.transition import TransitionBatch
from pearl_tpu_torch.training.online import online_learning
from pearl_tpu_torch.utils.device import DeviceLike, make_generator, resolve_device
from pearl_tpu_torch.utils.pytree import tree_map

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}

# logger(metrics, batches_done): each metric's mean over the chunk.
LearningLogger = Callable[[Dict[str, np.ndarray], int], None]


def transitions_from_arrays(
    *,
    state,
    action,
    reward,
    next_state,
    terminated,
    truncated=None,
    action_index=None,
    device: DeviceLike = None,
    **optional,
) -> TransitionBatch:
    """A TransitionBatch on `device` (the card unless "cpu") from columnar
    arrays: float32 states, actions and rewards, bool flags, int32 action
    indices (the first action column when not given); other fields keep
    their dtype, with 64-bit numbers narrowed to 32 bits as the JAX package
    stores them."""
    device = resolve_device(device)
    n = np.asarray(reward).shape[0]
    if truncated is None:
        truncated = np.zeros((n,), bool)
    if action_index is None:
        action_index = np.asarray(action)[:, 0].astype(np.int32)

    def put(x, dtype=None):
        x = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        x = x.astype(_NARROW.get(x.dtype, x.dtype), copy=False)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return TransitionBatch(
        state=put(state, np.float32),
        action=put(action, np.float32),
        reward=put(reward, np.float32),
        next_state=put(next_state, np.float32),
        terminated=put(terminated, bool),
        truncated=put(truncated, bool),
        action_index=put(action_index, np.int32),
        **{k: put(v) for k, v in optional.items()},
    )


def _batch_from_reference_pt(path: str, device) -> TransitionBatch:
    """The reference's dataset format: a torch-saved iterable of transition
    dicts with the keys observation, action, reward, next_observation,
    terminated and truncated (the last two may be missing: terminated then
    defaults to True, truncated to False)."""
    rows = list(torch.load(path, map_location="cpu", weights_only=False))
    n = len(rows)

    def col(key, default=None):
        if key not in rows[0]:
            return default
        return np.stack([np.atleast_1d(np.asarray(r[key])) for r in rows])

    return transitions_from_arrays(
        state=col("observation"),
        action=col("action"),
        reward=col("reward").reshape(n),
        next_state=col("next_observation"),
        terminated=col("terminated", np.ones((n, 1), bool)).reshape(n),
        truncated=col("truncated", np.zeros((n, 1), bool)).reshape(n),
        device=device,
    )


def _fetch(url: str) -> str:
    """`url` copied to a temporary file with the dataset's suffix; returns
    its path."""
    import tempfile
    import urllib.error
    import urllib.parse
    import urllib.request

    # The format comes from the URL's path: a ?query must not hide ".pt".
    suffix = ".pt" if urllib.parse.urlparse(url).path.endswith(".pt") else ".npz"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
        try:
            with urllib.request.urlopen(url) as resp:
                tmp.write(resp.read())
        except (urllib.error.URLError, OSError) as e:
            os.unlink(tmp.name)
            raise RuntimeError(
                f"could not fetch offline dataset {url!r}: {e}. If this "
                "environment has no network egress, download the file "
                "elsewhere and pass its local path (or a file:// URL)."
            ) from e
    return tmp.name


def get_offline_data_in_buffer(
    path: str, buffer: Optional[BasicReplayBuffer] = None, device: DeviceLike = None
):
    """Load a dataset (`.npz` or the reference's `.pt`, a local path or a
    URL) into `buffer` (a BasicReplayBuffer of the dataset's size when None)
    on `device`. Returns (buffer, buffer_state)."""
    device = resolve_device(device)
    tmp_path = _fetch(path) if "://" in path else None
    try:
        local = tmp_path or path
        if local.endswith(".pt"):
            batch = _batch_from_reference_pt(local, device)
        else:
            with np.load(local) as data:
                batch = transitions_from_arrays(
                    **{k: data[k] for k in data.files}, device=device
                )
    finally:
        if tmp_path is not None:
            os.unlink(tmp_path)
    return buffer_from_batch(batch, buffer)


def buffer_from_batch(batch: TransitionBatch, buffer: Optional[BasicReplayBuffer] = None):
    """`batch` pushed into `buffer` (a BasicReplayBuffer of its size when
    None) on the batch's device. Returns (buffer, buffer_state)."""
    if buffer is None:
        buffer = BasicReplayBuffer(capacity=batch.batch_size)
    example = tree_map(lambda x: x[:1], batch)
    return buffer, buffer.push(buffer.init(example), batch)


def save_offline_data(path: str, batch: TransitionBatch) -> None:
    """`batch` as a columnar `.npz`, one array per field that is not None
    (bfloat16 storage is written as float32)."""
    arrays = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is not None:
            v = v.detach()
            arrays[f.name] = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
    np.savez(path, **arrays)


def offline_learning(
    agent: PearlAgent,
    agent_state: AgentState,
    buffer: BasicReplayBuffer,
    buffer_state,
    *,
    number_of_batches: int = 1000,
    batch_size: int = 128,
    seed: int = 0,
    logger: Optional[LearningLogger] = None,
    log_every: int = 100,
) -> AgentState:
    """N x {uniform sample -> agent.learn_batch} on the buffer's device, in
    whole chunks of `log_every` batches until at least `number_of_batches`
    are done (so N rounds up to a multiple of `log_every`, as in the
    reference). The draws come from one device generator seeded with
    `seed`. Nothing reads the card inside a chunk; with a `logger`, each
    chunk ends with one copy of its metrics' means to the host."""
    device = buffer.device(buffer_state)
    generator = make_generator(seed, device)
    done = 0
    while done < number_of_batches:
        history: Dict[str, list] = {}
        for _ in range(log_every):
            batch = buffer.sample(buffer_state, generator, batch_size)
            agent_state, metrics = agent.learn_batch(agent_state, batch)
            if logger is not None:
                for k, v in metrics.items():
                    history.setdefault(k, []).append(torch.as_tensor(v, device=device))
        done += log_every
        if logger is not None:
            means = [torch.stack(v).float().mean() for v in history.values()]
            host = torch.stack(means).cpu().numpy() if means else np.zeros((0,))
            logger(dict(zip(history, host)), done)
    return agent_state


def offline_evaluation(
    agent: PearlAgent,
    agent_state: Optional[AgentState],
    env,
    *,
    num_envs: int = 16,
    max_steps: int = 20_000,
    seed: int = 1,
    device: DeviceLike = None,
) -> np.ndarray:
    """Greedy episodes without learning on `device` (the card unless "cpu");
    returns the finished episodes' returns. `agent_state` None evaluates a
    freshly initialised agent."""
    res = online_learning(
        agent,
        env,
        num_envs=num_envs,
        max_steps=max_steps,
        learn_every_k_steps=8,
        exploit=True,
        learn=False,
        seed=seed,
        agent_state=agent_state,
        device=device,
    )
    return res.episode_returns
