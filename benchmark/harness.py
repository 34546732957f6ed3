"""One run of one cell: set-up, the measured window, the traced
sub-window (``--trace 1``), the check against the plain reference, and
the result line.

The driver of the cell's traffic (``drivers/<name>.py``) gives a
``Session(config, traffic, seed, device, control)`` that builds the
program's objects and warms up every shape the cell uses, and has
``window(seconds)`` (the end-to-end metrics, by the host clock around
work that ends in a synchronize), ``traced()`` (one steady chunk of
work under the profiler), ``check()`` (the numbers compared, judged
against the cell's limits here) and ``notes`` (what the check saw
beside them: the share of ties, the verdicts judged; printed, not
judged).  ``control`` puts the check's control, a lower precision, in
the program's place for the readings of ``calibrate.py``; runs of the
benchmark never do.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
import types

# modules the process may not hold once the window has closed: JAX, the
# JAX package and the root's ``bench.py``, compared by whole top-level
# names
FORBIDDEN = ("jax", "jaxlib", "flax", "flowstate_tpu", "bench")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def span(enabled: bool, name: str):
    """A profiler span of the benchmark's own, or nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def device_fields(device) -> dict:
    """The card of a one-chip run and the peak of its memory."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit, none missing or not a number."""
    rows, correct = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = value is not None and not math.isnan(value) and value <= limit
        correct = correct and ok
        rows.append((name, value, limit))
    return correct, rows


def run_cell(bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control=None) -> dict:
    """The result of one run (a dict in the result line's layout)."""
    import torch

    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    driver = bench.driver(traffic["driver"])
    session = driver.Session(config, traffic, seed, device, control)
    setup_s = time.perf_counter() - t_start
    window = session.window(seconds)
    metrics = {}
    breakdown = None
    dev = None
    if trace:
        traced, tr = session.traced()
        ctx = types.SimpleNamespace(config=config, traffic=traffic,
                                    window=window, traced=traced, trace=tr)
        for m in bench.per_layer(cell_name):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        dev = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        print(f"profiler records: K1 {traced['k1_records']} of "
              f"{traced['k1_launches']} launches, K2 {traced['k2_records']} "
              f"of {traced['k2_launches']}", file=sys.stderr)
    else:
        for m in bench.end_to_end(cell_name):
            value = setup_s if m["name"] == "setup_s" else window[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_out = (device_fields(device) if torch.device(device).type == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": 1,
                        "memory_peak_bytes": 0})
    if dev:
        device_out.update(dev)
    numbers = session.check()
    correct, rows = judge(numbers, bench.limits(cell_name))
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {', '.join(found)}")
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": device_out}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = session.notes
    for name, value in session.notes.items():
        print(f"note {name}: {value!r}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result
