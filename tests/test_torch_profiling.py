"""The port's span recorder (``flowstate_tpu_torch/utils/profiling.py``)
and the spans its hot paths open: off, a span touches neither the
profiler, NVTX nor a clock; on, the record nests the spans as they ran and
puts their times on the exported Chrome trace's clock; the big-move round
and the production block open their spans per round and per block, and
give the same numbers with the spans on and off."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flowstate_tpu_torch.experiments import algorithm1
from flowstate_tpu_torch.experiments.common import (
    build_system, init_and_equilibrate,
)
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc import cuda_metropolis
from flowstate_tpu_torch.utils import profiling
from flowstate_tpu_torch.utils.config import ExperimentConfig
from flowstate_tpu_torch.utils.profiling import PhaseTimer, annotate

K = 2
ROUNDS = 2


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


def _raises(*args, **kwargs):
    raise AssertionError("called while the spans are off")


class _RaisingNvtx:
    range_push = range_pop = staticmethod(_raises)


@pytest.fixture
def nothing_called(monkeypatch):
    """The recorder's profiler, NVTX and clock, each raising if called."""
    monkeypatch.setattr(profiling, "record_function", _raises)
    monkeypatch.setattr(profiling, "nvtx", _RaisingNvtx)
    monkeypatch.setattr(profiling, "time_ns", _raises)
    monkeypatch.setattr(profiling._RECORD, "nvtx", True)


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


# ----- the recorder ------------------------------------------------------

def test_an_off_span_calls_no_profiler_nvtx_or_clock(nothing_called):
    span = annotate("off")
    assert span is annotate("another")          # one shared no-op
    with span:
        with annotate("inner"):
            torch.ones(4).sum()
    assert profiling.spans() == [] and profiling.summary() == {}


def test_spans_under_a_profiler_record_their_parents():
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("outer"):
            with annotate("a"):
                torch.ones(8).sum()
            with annotate("b"):
                with annotate("c"):
                    torch.ones(8).sum()
    with annotate("after"):                   # the profiler has stopped
        pass
    spans = {s.name: s for s in profiling.spans()}
    assert set(spans) == {"outer", "a", "b", "c"}
    assert spans["outer"].parent is None
    assert spans["a"].parent == spans["b"].parent == spans["outer"].id
    assert spans["c"].parent == spans["b"].id
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    outer = spans["outer"]
    assert outer.start_ns <= spans["a"].start_ns <= spans["c"].end_ns \
        <= outer.end_ns
    summary = profiling.summary()
    assert summary["outer"]["count"] == 1 and summary["c"]["dropped"] == 0
    children = sum(summary[n]["total_s"] for n in ("a", "b"))
    assert summary["outer"]["self_s"] == pytest.approx(
        summary["outer"]["total_s"] - children, abs=1e-9)
    assert summary["b"]["self_s"] <= summary["b"]["total_s"]


def test_recording_turns_the_spans_on_without_a_profiler():
    with profiling.recording():
        with annotate("x"):
            with annotate("y"):
                pass
    with annotate("z"):
        pass
    assert _names(profiling.spans()) == {"x": 1, "y": 1}


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"]: e for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"}


def test_span_times_lie_on_the_chrome_traces_clock(tmp_path):
    """Each span, put on the trace's clock by ``trace_us``, lies within
    100 µs of its ``user_annotation`` event at both ends.  A clock that is
    off misses on every try; a try is repeated only where the process was
    descheduled between the two readings."""
    with profile(activities=[ProfilerActivity.CPU]):  # the first call's cost
        with annotate("warm"):
            pass
    for attempt in range(3):
        profiling.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(8):
                with annotate(f"s{attempt}.{i}"):
                    torch.ones(256).sum()
        path = os.path.join(tmp_path, f"trace{attempt}.json")
        prof.export_chrome_trace(path)
        events = _annotations(path)
        gaps = []
        for s in profiling.spans():
            e = events[s.name]
            gaps += [abs(profiling.trace_us(s.start_ns) - float(e["ts"])),
                     abs(profiling.trace_us(s.end_ns)
                         - float(e["ts"]) - float(e["dur"]))]
        assert len(gaps) == 16
        if max(gaps) < 100.0:
            break
    assert max(gaps) < 100.0, gaps


def test_trace_us_counts_from_the_traces_base():
    base_s = 228 * profiling.TRACE_BASE_SECONDS
    assert profiling.trace_us(base_s * 10 ** 9 + 1_500) == 1.5
    assert profiling.trace_us((base_s - 1) * 10 ** 9) == pytest.approx(
        (profiling.TRACE_BASE_SECONDS - 1) * 1e6)


def test_the_raw_list_stops_at_its_cap(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.recording():
        for _ in range(8):
            with annotate("s"):
                pass
        with annotate("t"):
            pass
    assert len(profiling.spans()) == 5
    summary = profiling.summary()
    assert summary["s"]["count"] == 8 and summary["s"]["dropped"] == 3
    assert summary["t"]["count"] == 1 and summary["t"]["dropped"] == 1
    profiling.clear()
    assert profiling.spans() == [] and profiling.summary() == {}


def test_phase_timer_keeps_its_keys_with_the_spans_off():
    logged = []

    class Metrics:
        def log(self, event, **fields):
            logged.append((event, fields))

    timer = PhaseTimer(Metrics())
    for _ in range(3):
        with timer.phase("load"):
            with annotate("inside"):          # off: not recorded
                pass
    with timer.phase("save", sync_on=torch.ones(2)):
        pass
    summary = timer.summary()
    assert set(summary) == {"load", "save"}
    for row in summary.values():
        assert set(row) == {"count", "total_s", "mean_s"}
    assert summary["load"]["count"] == 3
    assert summary["load"]["total_s"] == pytest.approx(
        3 * summary["load"]["mean_s"])
    assert [e for e, _ in logged] == ["phase_time"] * 4
    assert logged[0][1]["phase"] == "load" and logged[0][1]["seconds"] >= 0
    # a phase is a span of the record; its timer reads its own phases only
    assert _names(profiling.spans()) == {"load": 3, "save": 1}
    assert set(PhaseTimer().summary()) == set()


# ----- the span sites ----------------------------------------------------

def _config():
    return ExperimentConfig(num_chains=8, master_seed=5, num_particles=3,
                            equilibration_steps=20, adjusting_frequency=10,
                            big_move_interval=6, big_move_attempts=ROUNDS,
                            K=K, hidden_units=8, num_bins=4, n_blocks=1)


def _rounds():
    """``run_testing`` on the CPU: a K=2 flow for two rounds."""
    cfg = _config()
    spec = build_system(cfg)
    model = build_circular_flow(
        cfg.num_particles, 2, cfg.half_box, K=K, hidden_units=8,
        num_bins=4, num_blocks=1, device="cpu",
        generator=torch.Generator().manual_seed(3))
    state = init_and_equilibrate(cfg, spec, "cpu")
    state, acc, pos = algorithm1.run_testing(
        cfg, spec, state, model, torch.Generator().manual_seed(4))
    return acc, pos, state.energy.numpy()


def _production():
    """``run_production_kernel`` on the CPU: three blocks of 5 moves."""
    cfg = _config()
    spec = build_system(cfg)
    state = init_and_equilibrate(cfg, spec, "cpu")
    state, obs = cuda_metropolis.run_production_kernel(spec, cfg.beta, state,
                                                       3, 5)
    return obs.positions.numpy(), obs.pressure.numpy(), state.energy.numpy()


def test_the_round_opens_its_spans_and_gives_the_same_numbers():
    off = _rounds()
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = _rounds()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    spans = profiling.spans()
    rounds = [s for s in spans if s.name == "a1.round"]
    assert len(rounds) == ROUNDS
    by_round = [_names(s for s in spans if r.start_ns <= s.start_ns
                       and s.end_ns <= r.end_ns and s is not r)
                for r in rounds]
    for names in by_round:
        assert names == {"mcmc.moves": 1, "pair.energy": 1,
                         "hybrid.verdict": 1, "flow.sample_and_log_prob": 1,
                         "flow.log_prob": 1, "flow.spline": 4 * K,
                         "flow.net": 2 * K}
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("flow.spline", "flow.net"):
            assert ids[s.parent].name in ("flow.sample_and_log_prob",
                                          "flow.log_prob")
    for r in rounds:
        verdict, = [s for s in spans if s.parent == r.id
                    and s.name == "hybrid.verdict"]
        assert _names(s for s in spans if s.parent == verdict.id) == {
            "pair.energy": 1, "flow.log_prob": 1}


def test_the_production_block_opens_its_spans_and_gives_the_same_numbers():
    off = _production()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _production()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    spans = profiling.spans()
    ids = {s.id: s for s in spans}
    blocks = [s for s in spans if s.name == "mcmc.block"]
    assert len(blocks) == 3
    for block in blocks:
        inside = _names(s for s in spans if s.parent == block.id)
        assert inside["mcmc.moves"] == 1 and inside["mcmc.observe"] == 1
        assert inside.get("pair.energy", 0) >= 1            # the resync
    assert all(ids[s.parent].name == "mcmc.block" for s in spans
               if s.name == "mcmc.observe")


def test_with_the_spans_off_no_site_calls_the_profiler_nvtx_or_a_clock(
        nothing_called):
    _rounds()
    _production()
    assert profiling.spans() == [] and profiling.summary() == {}
