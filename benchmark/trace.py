"""The traced sub-window: ``torch.profiler`` over a few steady steps, its
Chrome trace read back.

From the trace: the device operations (kernels, copies, sets) inside the
window, each tied to the host span that launched it by its correlation
id; the device's busy time as the union of their intervals; the idle
gaps between them, named by the benchmark's span and the host operation
under way when the device ran dry.  The window is the span
``bench.window`` on the host, which starts and ends with a synchronize.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Trace:
    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("ph") == "X"]
        window = [e for e in spans if e["name"] == WINDOW]
        if len(window) != 1:
            raise RuntimeError(f"{len(window)} '{WINDOW}' spans in the trace")
        self.t0 = float(window[0]["ts"])
        self.t1 = self.t0 + float(window[0]["dur"])
        self.spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                              e["name"]) for e in spans
                             if e["name"].startswith("bench.")
                             and e["name"] != WINDOW))
        launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                     if e.get("cat") in LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        self.ops = []     # (start, end, name, cat, launch time or None)
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                start = float(e["ts"])
                end = start + float(e["dur"])
                if start >= self.t0 and end <= self.t1:
                    corr = e.get("args", {}).get("correlation")
                    self.ops.append((start, end, e["name"], e["cat"],
                                     launch_ts.get(corr)))
        self.ops.sort()
        cpu = sorted((float(e["ts"]), e["name"]) for e in events
                     if e.get("cat") == "cpu_op" and e.get("ph") == "X")
        self._cpu_ts = [t for t, _ in cpu]
        self._cpu_names = [n for _, n in cpu]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, name_part: str = None) -> list:
        return [op for op in self.ops if op[3] == "kernel"
                and (name_part is None or name_part in op[2])]

    def _busy(self) -> list:
        merged = []
        for start, end, *_ in self.ops:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self._busy()) / 1e6

    def span_at(self, t: float) -> str:
        """The innermost benchmark span open at host time ``t``."""
        inner = None
        for start, end, name in self.spans:
            if start > t:
                break
            if end >= t and (inner is None or start >= inner[0]):
                inner = (start, name)
        return inner[1] if inner else "outside spans"

    def launched_in(self, span_names) -> list:
        """Device operations launched inside the named spans."""
        spans = [(s, e) for s, e, n in self.spans if n in span_names]
        return [op for op in self.ops if op[4] is not None
                and any(s <= op[4] <= e for s, e in spans)]

    def device_ops(self, top: int = 10) -> list:
        total = collections.Counter()
        for start, end, name, *_ in self.ops:
            total[name] += (end - start) / 1e6
        return [[n, s] for n, s in total.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds by what the host was doing when the device ran dry:
        the benchmark's span, and the last host operation begun before."""
        total = collections.Counter()
        prev = self.t0
        for start, end in self._busy() + [[self.t1, self.t1]]:
            if start > prev:
                i = bisect.bisect_right(self._cpu_ts, prev) - 1
                op = self._cpu_names[i] if i >= 0 else "none"
                total[f"{self.span_at(prev)} / {op}"] += (start - prev) / 1e6
            prev = max(prev, end)
        return [[n, s] for n, s in total.most_common(top)]


def profile(fn, record_function):
    """``(fn's result, Trace)`` of ``fn()`` run inside the window span
    under the profiler (CPU and CUDA activities); the Chrome trace goes
    through a temporary file that is removed."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace(events)
