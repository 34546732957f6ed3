"""The program's own spans (``flowstate_tpu_torch/utils/profiling.py``)
joined with the traced chunk: the device operations launched inside a
span, and the idle gaps that opened inside one.

The program records each span's host start and end while the profiler
runs, and ``profiling.trace_us`` puts them on the Chrome trace's clock,
on which ``Trace.ops`` holds each operation's launch.  A span is found at
a time by its record's parent ids: the innermost span open at ``t`` is the
last one begun at or before ``t``, or the first of its ancestors still
open at ``t``.

``joined`` is None where the join cannot be trusted: a program without
the recorder, spans dropped past its cap, no record of the move kernel
(K1), or a K1 record launched outside an ``mcmc.moves`` span, or a
pair-energy (K2) record outside a ``pair.energy`` span.  The readers then
give no number rather than a misattributed one.
"""

from __future__ import annotations

import bisect

K1, K1_SPAN = "metropolis_moves", "mcmc.moves"
K2, K2_SPAN = "pair_", "pair.energy"


class ProgramSpans:
    def __init__(self, records: list, trace_us):
        # (start, end, name, parent id) on the trace's clock, by id
        self.by_id = {s.id: (trace_us(s.start_ns), trace_us(s.end_ns), s.name,
                             s.parent) for s in records}
        self.order = sorted((v[0], k) for k, v in self.by_id.items())
        self._starts = [t for t, _ in self.order]

    def innermost(self, t: float):
        """The id of the innermost span open at trace time ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        sid = self.order[i][1] if i >= 0 else None
        while sid in self.by_id and self.by_id[sid][1] < t:
            sid = self.by_id[sid][3]
        return sid if sid in self.by_id else None

    def name_at(self, t: float):
        sid = self.innermost(t)
        return None if sid is None else self.by_id[sid][2]

    def inside(self, t: float, name: str) -> bool:
        """Whether ``t`` falls in a span called ``name``, at any depth."""
        sid = self.innermost(t)
        while sid in self.by_id:
            if self.by_id[sid][2] == name:
                return True
            sid = self.by_id[sid][3]
        return False

    def count(self, name: str, t0: float, t1: float) -> int:
        """Spans called ``name`` wholly inside ``[t0, t1]``."""
        return sum(1 for s, e, n, _ in self.by_id.values()
                   if n == name and t0 <= s and e <= t1)

    def launched_in(self, tr, name: str) -> list:
        """The trace's device operations launched inside ``name`` spans."""
        return [op for op in tr.ops
                if op[4] is not None and self.inside(op[4], name)]

    def idle_gaps(self, tr) -> list:
        """``(start, length)`` of each idle gap of the traced window, in
        µs, its start the time the device ran dry."""
        gaps, prev = [], tr.t0
        for start, end in tr._busy() + [[tr.t1, tr.t1]]:
            if start > prev:
                gaps.append((prev, start - prev))
            prev = max(prev, end)
        return gaps


def _held(spans: ProgramSpans, tr) -> bool:
    k1, k2 = tr.kernels(K1), tr.kernels(K2)
    return bool(k1) and all(
        op[4] is not None and spans.inside(op[4], span)
        for records, span in ((k1, K1_SPAN), (k2, K2_SPAN))
        for op in records)


def joined(tr):
    """The program's spans on the trace ``tr``'s clock, or None (see the
    module's docstring)."""
    try:
        from flowstate_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "summary",
                                                "trace_us")):
        return None
    if any(row["dropped"] for row in profiling.summary().values()):
        return None
    spans = ProgramSpans(profiling.spans(), profiling.trace_us)
    return spans if _held(spans, tr) else None


def idle_per_unit(ctx, unit: str, opened_in) -> float:
    """Idle µs of the traced chunk whose gap opened where
    ``opened_in(spans, t)`` holds, over the chunk's ``unit`` spans."""
    spans = joined(ctx.trace)
    if spans is None:
        return None
    units = spans.count(unit, ctx.trace.t0, ctx.trace.t1)
    if not units:
        return None
    return sum(length for start, length in spans.idle_gaps(ctx.trace)
               if opened_in(spans, start)) / units


def device_ms_per_round(ctx, name: str):
    """Device milliseconds a round of the operations launched inside
    ``name`` spans, over the traced chunk's ``a1.round`` spans."""
    spans = joined(ctx.trace)
    if spans is None:
        return None
    rounds = spans.count("a1.round", ctx.trace.t0, ctx.trace.t1)
    ops = spans.launched_in(ctx.trace, name)
    if not rounds or not ops:
        return None
    return sum(end - start for start, end, *_ in ops) / 1e3 / rounds
