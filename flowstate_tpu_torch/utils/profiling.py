"""Profiling hooks: a device trace, named spans and per-phase timers.

Port of ``flowstate_tpu/utils/profiling.py`` (:37-75) on ``torch.profiler``:

* ``trace(log_dir)``  — a ``torch.profiler`` trace of the host and, where
  there is a card, of its kernels, written under ``log_dir`` as a Chrome
  trace (TensorBoard's profile plugin reads it);
* ``annotate(name)``  — a named span; the port opens them at the layer
  boundaries of its hot paths (below);
* ``PhaseTimer``      — per-phase wall-clock timings, optionally sent to a
  ``MetricsWriter``.

A span is off unless a ``torch.profiler`` session records or the code runs
inside ``recording()``.  Off, ``annotate`` checks two flags and returns a
shared no-op context: no ``record_function``, no NVTX range, no clock read
and no allocation, so the spans cost a hot path some 0.3 µs each.  On, a
span opens ``record_function(name)`` while a profiler records (the span
lands in its Chrome trace), an NVTX range on the card, and adds itself to
this process's record: the raw spans (name, id, parent id, host start and
end in Unix-epoch nanoseconds), at most ``MAX_SPANS`` of them, the rest
counted as dropped; and per name the count, the total time and the self
time (the total less what its recorded children cover).  ``spans()``,
``summary()`` and ``clear()`` read and empty the record; ``trace_us``
puts a span's times on the clock of the exported Chrome trace.  Spans
nest by the order they open and close, as on one thread.

The port's spans, where they open:

* ``a1.round``: ``experiments/algorithm1.run_testing``, each round;
* ``mcmc.moves``: ``mcmc/cuda_metropolis.run_moves_auto``, the move
  kernel's launch or the plain engine on the CPU;
* ``flow.sample_and_log_prob``, ``flow.log_prob``:
  ``flows/core.NormalizingFlow``, one flow pass each;
* ``flow.net``: ``flows/coupling.CircularSplineCoupling._apply_net``, the
  conditioner (residual net, transformer, EGNN);
* ``flow.gnn.messages``: ``flows/nets.TorusEGNN.apply``, inside
  ``flow.net``, the EGNN's message passing (its layers, without the
  embedding, the mean and the output linear): the plain composition or,
  on the card without autograd, the EGNN kernel's launch;
* ``flow.spline``: ``ops/splines.unconstrained_rational_quadratic_spline``
  (the plain composition) and, on the card without autograd, the spline
  kernel's launch in ``unconstrained_rational_quadratic_spline_sum``;
* ``pair.energy``: ``mcmc/state.batched_energy_virial``, the pair-energy
  kernel or its plain version;
* ``hybrid.verdict``: ``mcmc/hybrid.apply_big_moves``, the proposals'
  energies, the current point's log q and the verdict;
* ``mcmc.block``: ``mcmc/metropolis.run_production_with``, each block (the
  moves, the resync, the sample);
* ``mcmc.observe``: the same block's ``sample_observables``.

JAX's ``enable_compilation_cache`` has no counterpart: PyTorch runs
eagerly and the kernels' builds are cached by ``kernels/build.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from time import time_ns
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.cuda import nvtx
from torch.profiler import record_function

# the raw spans the record keeps; later ones are counted, not kept
MAX_SPANS = 1 << 16
# Kineto writes a Chrome trace's times after a base of the Unix epoch
# floored to intervals of this many seconds (its ``baseTimeNanoseconds``)
TRACE_BASE_SECONDS = 7889238


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # the id of the span it opened inside, or None
    start_ns: int           # host clock, Unix-epoch nanoseconds
    end_ns: int


class _Record:
    """This process's spans: the raw list and the per-name aggregates."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.next_id = 1
        self.depth = 0              # ``recording()`` blocks open
        self.nvtx: Optional[bool] = None
        self.clear()

    def clear(self) -> None:
        self.spans: List[Span] = []
        # name -> [count, total ns, self ns, dropped]
        self.totals: Dict[str, List[int]] = {}


_RECORD = _Record()
_OFF = contextlib.nullcontext()


class _Span:
    """An open span (``annotate`` when on)."""

    __slots__ = ("name", "id", "parent", "rf", "start_ns", "child_ns", "ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        rec = _RECORD
        self.id = rec.next_id
        rec.next_id += 1
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        if rec.nvtx is None:
            rec.nvtx = torch.cuda.is_available()
        if rec.nvtx:
            nvtx.range_push(self.name)
        self.child_ns = 0
        self.start_ns = time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time_ns()
        rec = _RECORD
        if rec.nvtx:
            nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.stack.pop()
        self.ns = end - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += self.ns
        row = rec.totals.setdefault(self.name, [0, 0, 0, 0])
        row[0] += 1
        row[1] += self.ns
        row[2] += self.ns - self.child_ns
        if len(rec.spans) < MAX_SPANS:
            rec.spans.append(Span(self.name, self.id,
                                  None if self.parent is None
                                  else self.parent.id, self.start_ns, end))
        else:
            row[3] += 1


def annotate(name: str):
    """A named span (a context manager): a no-op unless a profiler records
    or ``recording()`` is open (see the module's docstring)."""
    if _RECORD.depth or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn the spans on inside the block, without a profiler."""
    _RECORD.depth += 1
    try:
        yield
    finally:
        _RECORD.depth -= 1


def spans() -> List[Span]:
    """The recorded spans, in the order they closed (at most
    ``MAX_SPANS``)."""
    return list(_RECORD.spans)


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``total_s``, ``self_s`` and ``dropped``
    (closed past ``MAX_SPANS``, so not among ``spans()``)."""
    return {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9,
                   "dropped": d}
            for name, (c, t, s, d) in _RECORD.totals.items()}


def clear() -> None:
    """Empty the record (spans still open are recorded when they close)."""
    _RECORD.clear()


def trace_us(t_ns: int) -> float:
    """A host time in Unix-epoch nanoseconds (a span's ``start_ns`` or
    ``end_ns``) as a Chrome trace's ``ts``: microseconds after the trace's
    ``baseTimeNanoseconds``."""
    base = t_ns // 10 ** 9 // TRACE_BASE_SECONDS * TRACE_BASE_SECONDS
    return (t_ns - base * 10 ** 9) / 1e3


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


class PhaseTimer:
    """Wall-clock seconds per named phase: each phase is a span that is
    always recorded, and its timer keeps its own phases' totals."""

    def __init__(self, metrics=None):
        self.totals: Dict[str, List[float]] = {}   # name -> [count, s]
        self.metrics = metrics

    @contextlib.contextmanager
    def phase(self, name: str,
              sync_on: Optional[torch.Tensor] = None) -> Iterator[None]:
        """Time a phase; with ``sync_on`` (a tensor) wait for its card
        first, since a card's work returns before it is done."""
        with _Span(name) as span:
            yield
            _sync(sync_on)
        dt = span.ns / 1e9
        row = self.totals.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += dt
        if self.metrics is not None:
            self.metrics.log("phase_time", phase=name, seconds=dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": c, "total_s": t, "mean_s": t / c}
                for name, (c, t) in self.totals.items()}
