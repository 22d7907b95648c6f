"""Tree utilities over dataclasses, dicts, tuples and tensors (port of
`pearl_tpu/utils/pytree.py`): per-env conditional state updates for the
asynchronous auto-reset, target-network soft updates, the act path's cast
copy of a network, and the comparison of two whole states (`compare`,
`tree_allclose`) over one flattening into named leaves (`walk_leaves`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Apply `fn` leaf-wise over matching dataclasses or dicts of tensors.
    `None` leaves stay `None`; non-tensor leaves come from the first tree."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(
            first,
            **{
                f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                for f in dataclasses.fields(first)
                if f.init
            },
        )
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return first


def tree_select(cond: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """`torch.where` over every leaf, broadcasting `cond` (B,) from the left
    over leaves of shape (B, ...)."""

    def _sel(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return tree_map(_sel, on_true, on_false)


@torch.no_grad()
def soft_update(target, source, tau: float) -> None:
    """target <- target + tau * (source - target), in place, over two
    `nn.Module`s with the same parameters. Written as the reference writes it
    (`t + tau * (s - t)`), not with `lerp_`, whose formula changes at 0.5."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.add_(s - t, alpha=tau)


def synced_cast(cast, source):
    """`cast` (a copy of the `nn.Module` `source` in a lower dtype), recast
    from `source` if that was written since the last cast: by a learn step,
    a weight load, a `load_state_dict`, or because the caller now holds
    another module. Each parameter's identity and in-place version counter
    are compared on the host, so an unchanged step costs no launch and no
    sync. (A write through `.data` bypasses the counter: write parameters
    under `torch.no_grad()` instead.)"""
    stamp = tuple((id(p), p._version) for p in source.parameters())
    if getattr(cast, "_cast_of", None) != stamp:
        with torch.no_grad():
            for c, p in zip(cast.parameters(), source.parameters()):
                c.copy_(p)
        cast._cast_of = stamp
    return cast


# ------------------------------------------------------- state comparison
_HOST_TYPES = (bool, int, float, str, type(None))


def walk_leaves(tree: Any, prefix: str = ""):
    """(name, leaf) for every leaf of a port state, in a fixed order. Leaves
    are tensors, `torch.Generator`s and host values (bool, int, float, str,
    None). An `nn.Module` contributes its `state_dict` (parameters and
    buffers); an optimizer its `state_dict` tensors and each param group's
    hyperparameters (the tensor `lr` among them), but not the indices of its
    parameters; dataclasses, dicts, tuples and lists their entries."""
    if isinstance(tree, (torch.Tensor, torch.Generator) + _HOST_TYPES):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for k, v in tree.state_dict().items():
            yield f"{prefix}.{k}", v
    elif isinstance(tree, torch.optim.Optimizer):
        sd = tree.state_dict()
        for idx, st in sd["state"].items():
            for k, v in st.items():
                yield f"{prefix}.state[{idx}].{k}", v
        for gi, group in enumerate(sd["param_groups"]):
            for k, v in group.items():
                if k != "params":
                    yield from walk_leaves(v, f"{prefix}.param_groups[{gi}].{k}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from walk_leaves(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk_leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from walk_leaves(v, f"{prefix}[{i}]")
    else:
        raise TypeError(f"{prefix or 'the state'}: cannot flatten a {type(tree).__name__}")


def named_leaves(tree: Any) -> list:
    """`walk_leaves` with each generator replaced by its state (a uint8
    tensor on the host), so that two states compare leaf by leaf."""
    return [
        (name, leaf.get_state() if isinstance(leaf, torch.Generator) else leaf)
        for name, leaf in walk_leaves(tree)
    ]


def compare(a: Any, b: Any, rtol: float = 1e-5, atol: float = 1e-7) -> str:
    """Readable differences of two states, "" when they agree: a float leaf
    within rtol/atol; integer, bool and generator leaves, and host values
    other than floats, exactly (a relative tolerance would swallow a step
    counter off by one)."""
    la, lb = named_leaves(a), named_leaves(b)
    names_a, names_b = [n for n, _ in la], [n for n, _ in lb]
    if names_a != names_b:
        only_a = sorted(set(names_a) - set(names_b))
        only_b = sorted(set(names_b) - set(names_a))
        return f"structures differ: only in the first {only_a}, only in the second {only_b}"
    diffs = []
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            diffs.append(f"{name}: {type(x).__name__} vs {type(y).__name__}")
        elif not isinstance(x, torch.Tensor):
            if isinstance(x, float) and isinstance(y, float):
                if not abs(x - y) <= atol + rtol * abs(y):
                    diffs.append(f"{name}: {x!r} vs {y!r}")
            elif type(x) is not type(y) or x != y:
                diffs.append(f"{name}: {x!r} vs {y!r}")
        elif x.shape != y.shape or x.dtype != y.dtype:
            diffs.append(f"{name}: {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
        else:
            y = y.to(x.device)
            if not (x.is_floating_point() or x.is_complex()):
                if not torch.equal(x, y):
                    diffs.append(f"{name}: integer/bool leaves differ")
            # torch.equal holds only where no element is NaN, so it is a
            # fast path of allclose with the same verdict.
            elif not (torch.equal(x, y) or torch.allclose(x, y, rtol=rtol, atol=atol)):
                err = (x.double() - y.double()).abs().max().item()
                diffs.append(f"{name}: max abs diff {err:.3e}")
    return "; ".join(diffs)


def tree_allclose(a: Any, b: Any, rtol: float = 1e-5, atol: float = 1e-7) -> bool:
    """True if two states have the same leaves and `compare` finds no
    difference."""
    return compare(a, b, rtol=rtol, atol=atol) == ""
