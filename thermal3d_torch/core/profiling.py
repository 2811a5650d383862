"""Tracing and profiling helpers (counterpart of thermal3d/core/profiling.py),
on torch.profiler:

  * `trace(logdir)`: a torch.profiler run over the block (CPU, and CUDA when
    there is a card), written to `logdir` as a Chrome trace (Perfetto,
    chrome://tracing); yields the profiler, whose key_averages() sum the
    spans by name.
  * `annotate(name)`: a record_function span that labels a phase inside a
    trace.
  * `StageTimer`: wall-clock time by named stage; `stage(name, *tensors)`
    synchronises the CUDA devices of the tensors it is given before it
    stops the clock, so device work counts to its stage.
  * `nan_guard()`: raises FloatingPointError at the first op whose floating
    output holds a NaN (the JAX `jax_debug_nans` mode; torch's anomaly mode
    checks only the backward).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write `logdir/trace_<pid>_<ns>.json`."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and torch.isnan(t).any():
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise FloatingPointError at the first op of the block that makes a
    NaN. Each check reads the output back to the host: a debugging mode."""
    with _NanGuard():
        yield


class StageTimer:
    """Accumulates wall-clock time by named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors: torch.Tensor):
        t0 = time.perf_counter()
        yield
        for device in {t.device for t in sync_tensors if t.is_cuda}:
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
