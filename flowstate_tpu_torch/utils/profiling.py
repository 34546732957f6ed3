"""Profiling hooks: a device trace, named ranges and per-phase timers.

Port of ``flowstate_tpu/utils/profiling.py`` (:37-75) on ``torch.profiler``:

* ``trace(log_dir)``  — a ``torch.profiler`` trace of the host and, where
  there is a card, of its kernels, written under ``log_dir`` as a Chrome
  trace (TensorBoard's profile plugin reads it);
* ``annotate(name)``  — a named range that shows in the profiler's
  timeline, and on the card also as an NVTX range;
* ``PhaseTimer``      — per-phase wall-clock timings, optionally sent to a
  ``MetricsWriter``.

JAX's ``enable_compilation_cache`` has no counterpart: PyTorch runs
eagerly and the kernels' builds are cached by ``kernels/build.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


def _sync(on: Optional[torch.Tensor]) -> None:
    """Wait for ``on``'s device, if it is a card."""
    if on is not None and on.device.type == "cuda":
        torch.cuda.synchronize(on.device)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block: host activity, and the card's kernels where torch
    sees one; the trace goes to ``log_dir/trace_<pid>_<time>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the profiler's timeline (``record_function``) and,
    on the card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class PhaseTimer:
    """Wall-clock seconds per named phase."""

    def __init__(self, metrics=None):
        self.times: Dict[str, List[float]] = {}
        self.metrics = metrics

    @contextlib.contextmanager
    def phase(self, name: str,
              sync_on: Optional[torch.Tensor] = None) -> Iterator[None]:
        """Time a phase; with ``sync_on`` (a tensor) wait for its card
        first, since a card's work returns before it is done."""
        t0 = time.perf_counter()
        yield
        _sync(sync_on)
        dt = time.perf_counter() - t0
        self.times.setdefault(name, []).append(dt)
        if self.metrics is not None:
            self.metrics.log("phase_time", phase=name, seconds=dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(ts), "total_s": sum(ts),
                       "mean_s": sum(ts) / len(ts)}
                for name, ts in self.times.items()}
