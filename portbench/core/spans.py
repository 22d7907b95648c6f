"""Spans and counters the benchmark installs from its own files.

`Spans.install()` wraps, on the class, `PearlAgent.act`, `.observe` and
`.learn` and `VectorEnv.step`, and every public op of `pearl_tpu_torch.ops`
in each loaded `pearl_tpu_torch` module that binds it (the module that
defines it keeps its own name: its wrappers count their launches through
it). Each wrapper opens a `torch.profiler.record_function` range named after
its span and adds its host-clock seconds to the span's total; an op's wrapper
also adds the bytes its call needs, from the op's counter in `counts/`, when
there is one, and, where that counter also counts operations (`flops`), the
seconds those operations take at the peak of the precision they run at.
`remove()` puts every original back.
"""

from __future__ import annotations

import collections
import functools
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.core import peaks

LAYER_SPANS = {"act": ("agent", "act"), "observe": ("agent", "observe"),
               "learn": ("agent", "learn"), "env": ("vector", "step")}
OP_PREFIX = "op:"


class Spans:
    def __init__(self, byte_counter: Callable[[str], Optional[Callable]],
                 flop_counter: Callable[[str], Optional[Callable]]):
        self.byte_counter = byte_counter
        self.flop_counter = flop_counter
        self.host: Dict[str, float] = collections.defaultdict(float)
        self.op_bytes: Dict[str, int] = collections.defaultdict(int)
        self.op_flops: Dict[str, float] = collections.defaultdict(float)  # peak-seconds
        self._restore: List[Tuple[object, str, object]] = []

    def reset(self) -> None:
        self.host.clear()
        self.op_bytes.clear()
        self.op_flops.clear()

    def _wrap(self, name: str, fn: Callable, counter: Optional[Callable] = None,
              flops: Optional[Callable] = None) -> Callable:
        spans = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            spans.host[name] += time.perf_counter() - t0
            if counter is not None:
                spans.op_bytes[name[len(OP_PREFIX):]] += counter(args, kwargs)
            if flops is not None:
                n, precision = flops(args, kwargs)
                spans.op_flops[name[len(OP_PREFIX):]] += n / peaks.FLOPS[precision]
            return out

        return wrapped

    def _patch(self, owner, attr: str, new) -> None:
        self._restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def install(self) -> None:
        from pearl_tpu_torch import ops
        from pearl_tpu_torch.agent.pearl_agent import PearlAgent
        from pearl_tpu_torch.envs.vector import VectorEnv

        owners = {"agent": PearlAgent, "vector": VectorEnv}
        for name, (owner, attr) in LAYER_SPANS.items():
            cls = owners[owner]
            self._patch(cls, attr, self._wrap(name, getattr(cls, attr)))
        for op in ops.__all__:
            fn = getattr(ops, op)
            if op.endswith("_reference") or not callable(fn) or not hasattr(fn, "launches"):
                continue
            wrapped = self._wrap(OP_PREFIX + op, fn, self.byte_counter(op),
                                 self.flop_counter(op))
            for mod_name, mod in list(sys.modules.items()):
                if (mod is None or not mod_name.startswith("pearl_tpu_torch")
                        or mod_name == fn.__module__):
                    continue
                if getattr(mod, op, None) is fn:
                    self._patch(mod, op, wrapped)

    def remove(self) -> None:
        for owner, attr, old in reversed(self._restore):
            setattr(owner, attr, old)
        self._restore.clear()
