"""Checkpointing (port of `pearl_tpu/utils/checkpoint.py`).

The reference saves its state pytree with Orbax. A port state holds
`nn.Module`s, optimizers bound to their parameters and `torch.Generator`s, so
here the whole state is one `torch.save` pickle: one file, in which an
optimizer and the module it steps share their parameter objects, so a
restored optimizer keeps stepping the restored module, and a generator comes
back with its stream where it was. `restore` unpickles: load only files this
program wrote.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from pearl_tpu_torch.utils.pytree import walk_leaves


def save(path: str, state: Any) -> None:
    """Write any port state (an `AgentState`, a list of them, ...) to the
    file `path`, making its directory if needed."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)


def _leaf_device(leaf):
    """A tensor's or generator's device with its index (a generator made on
    "cuda" reports no index), None for a host value."""
    if not isinstance(leaf, (torch.Tensor, torch.Generator)):
        return None
    device = leaf.device
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def restore(path: str, example: Any) -> Any:
    """The state saved at `path`, on the devices of `example` (a state of the
    same structure, e.g. a freshly initialized one): storages saved on an
    accelerator land on `example`'s accelerator, or on the host when
    `example` has none; host storages stay on the host. Raises ValueError if
    the leaves' names differ from `example`'s, or if a leaf cannot land on
    its example's device (a generator keeps the device it was saved on)."""
    want = list(walk_leaves(example))
    devices = {_leaf_device(leaf) for _, leaf in want} - {None}
    accelerators = {d for d in devices if d.type != "cpu"}
    if len(accelerators) > 1:
        raise ValueError(
            f"the example spans several accelerators: {sorted(map(str, accelerators))}"
        )
    target = accelerators.pop() if accelerators else torch.device("cpu")

    def location(storage, loc):
        if loc.startswith("cpu"):
            return None  # the default: stays on the host
        if target.type == "cpu":
            return storage
        return storage.to(device=target)

    state = torch.load(os.path.abspath(path), map_location=location, weights_only=False)
    got = list(walk_leaves(state))
    if [n for n, _ in got] != [n for n, _ in want]:
        raise ValueError(f"{path} holds a state of another structure than the example")
    for (name, leaf), (_, ref) in zip(got, want):
        if _leaf_device(leaf) != _leaf_device(ref):
            raise ValueError(
                f"{name}: restored on {_leaf_device(leaf)}, the example is on {_leaf_device(ref)}"
            )
    return state
