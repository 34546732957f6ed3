"""The readers of the program's spans (``benchmark/program_spans.py`` and
the four metrics that use it), on a hand-written trace and span record:
device operations and idle gaps go to the innermost program span, the
sums are exact, a move-kernel record launched outside ``mcmc.moves``
leaves every reader without a number, and so does a program without the
recorder."""

import types

import pytest

from benchmark.loader import Benchmark
from benchmark.tests.standin import REPO
from benchmark.trace import Trace
from flowstate_tpu_torch.utils import profiling

ROUND_METRICS = ("spline_device_ms_per_round", "net_device_ms_per_round",
                 "flow_idle_ms_per_round")
BLOCK_METRIC = "block_idle_us_per_block"

# a round on the trace's clock (µs): (id, name, parent, start, end)
ROUND_SPANS = [
    (1, "a1.round", None, 10, 900),
    (2, "mcmc.moves", 1, 20, 60),
    (3, "flow.sample_and_log_prob", 1, 100, 400),
    (4, "flow.net", 3, 110, 200),
    (5, "flow.spline", 3, 210, 300),
    (6, "hybrid.verdict", 1, 420, 800),
    (7, "pair.energy", 6, 430, 450),
    (8, "flow.log_prob", 6, 500, 780),
    (9, "flow.spline", 8, 510, 600),
    (10, "flow.net", 8, 610, 700),
]
# device operations: (name, launch, start, end)
ROUND_OPS = [
    ("metropolis_moves_kernel", 30, 40, 140),
    ("sgemm", 150, 150, 250),                  # in flow.net; idle 140-150
    ("scan", 250, 260, 330),                   # in flow.spline; idle 250-260
    ("cat", 350, 360, 410),                    # in the pass, outside both
    ("pair_group_kernel", 440, 440, 460),      # idle 410-440 in the round
    ("scan", 520, 520, 590),                   # in flow.spline; idle 460-520
    ("sgemm", 620, 620, 690),                  # in flow.net; idle 590-620
    ("where", 790, 800, 950),                  # idle 690-800; 950-1000 out
]

BLOCK_SPANS = [
    (1, "mcmc.block", None, 10, 200),
    (2, "mcmc.moves", 1, 20, 50),
    (3, "pair.energy", 1, 60, 80),
    (4, "mcmc.observe", 1, 90, 190),
    (5, "mcmc.block", None, 210, 400),
    (6, "mcmc.moves", 5, 215, 240),
    (7, "pair.energy", 5, 250, 270),
    (8, "mcmc.observe", 5, 280, 390),
]
BLOCK_OPS = [
    ("metropolis_moves_kernel", 30, 35, 100),
    ("pair_group_kernel", 70, 100, 110),
    ("fill", 95, 120, 125),                    # idle 110-120 in the block
    ("metropolis_moves_kernel", 220, 225, 300),  # idle 125-225 opened in it
    ("pair_group_kernel", 260, 300, 310),
    ("copy", 410, 420, 480),                   # idle 310-420 opened in it
]


def _trace(ops, window_us):
    events = [{"cat": "user_annotation", "ph": "X", "name": "bench.window",
               "ts": 0.0, "dur": float(window_us)}]
    for corr, (name, launch, start, end) in enumerate(ops):
        events.append({"cat": "cuda_runtime", "ph": "X",
                       "name": "cudaLaunchKernel", "ts": float(launch),
                       "dur": 1.0, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "ph": "X", "name": name,
                       "ts": float(start), "dur": float(end - start),
                       "args": {"correlation": corr}})
    return Trace(events)


def _record(monkeypatch, spans):
    """The program's record holding ``spans`` (µs on the trace's clock:
    near the base, host nanoseconds are a thousand times them)."""
    monkeypatch.setattr(profiling, "spans", lambda: [
        profiling.Span(name, sid, parent, start * 1000, end * 1000)
        for sid, name, parent, start, end in spans])
    monkeypatch.setattr(profiling, "summary", lambda: {})


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def _read(bench, metric, trace):
    ctx = types.SimpleNamespace(trace=trace, traced={"units": 1})
    return bench.reader(metric)(ctx)


def test_the_round_readers_split_the_flow_by_the_innermost_span(
        bench, monkeypatch):
    _record(monkeypatch, ROUND_SPANS)
    tr = _trace(ROUND_OPS, 1000)
    assert _read(bench, "spline_device_ms_per_round", tr) == \
        pytest.approx((70 + 70) / 1e3, abs=1e-12)
    assert _read(bench, "net_device_ms_per_round", tr) == \
        pytest.approx((100 + 70) / 1e3, abs=1e-12)
    # flow idle: 140-150 (net), 250-260 (spline), 330-360 (the pass),
    # 590-620 (spline), 690-800 (net); not 0-40, 410-440, 460-520 nor
    # 950-1000
    assert _read(bench, "flow_idle_ms_per_round", tr) == \
        pytest.approx((10 + 10 + 30 + 30 + 110) / 1e3, abs=1e-12)
    assert _read(bench, BLOCK_METRIC, tr) is None      # no blocks


def test_two_rounds_give_the_same_readings_a_round(bench, monkeypatch):
    shifted = [(sid + 100, name, None if parent is None else parent + 100,
                start + 1000, end + 1000)
               for sid, name, parent, start, end in ROUND_SPANS]
    _record(monkeypatch, ROUND_SPANS + shifted)
    ops = ROUND_OPS + [(n, lt + 1000, s + 1000, e + 1000)
                       for n, lt, s, e in ROUND_OPS]
    tr = _trace(ops, 2000)
    assert _read(bench, "spline_device_ms_per_round", tr) == \
        pytest.approx(0.14, abs=1e-12)
    # the first round's last gap (950-1040) opened outside every span
    assert _read(bench, "flow_idle_ms_per_round", tr) == \
        pytest.approx(0.19, abs=1e-12)


def test_the_block_reader_puts_idle_to_the_block(bench, monkeypatch):
    _record(monkeypatch, BLOCK_SPANS)
    tr = _trace(BLOCK_OPS, 500)
    # 110-120, 125-225 and 310-420 opened inside a block; 0-35 and 480-500
    # outside; over two blocks
    assert _read(bench, BLOCK_METRIC, tr) == pytest.approx(
        (10 + 100 + 110) / 2, abs=1e-9)
    for metric in ROUND_METRICS:
        assert _read(bench, metric, tr) is None        # no rounds


@pytest.mark.parametrize("where", ["k1_outside", "k2_outside", "no_k1"])
def test_a_kernel_outside_its_span_leaves_no_number(bench, monkeypatch,
                                                    where):
    ops, block_ops = list(ROUND_OPS), list(BLOCK_OPS)
    if where == "k1_outside":
        ops[0] = ("metropolis_moves_kernel", 70, 80, 140)   # after 20-60
        block_ops[0] = ("metropolis_moves_kernel", 55, 55, 100)
    elif where == "k2_outside":
        ops[4] = ("pair_group_kernel", 455, 455, 460)       # after 430-450
        block_ops[1] = ("pair_group_kernel", 85, 100, 110)
    else:
        ops = [op for op in ops if not op[0].startswith("metropolis")]
        block_ops = [op for op in block_ops
                     if not op[0].startswith("metropolis")]
    _record(monkeypatch, ROUND_SPANS)
    for metric in ROUND_METRICS:
        assert _read(bench, metric, _trace(ops, 1000)) is None
    _record(monkeypatch, BLOCK_SPANS)
    assert _read(bench, BLOCK_METRIC, _trace(block_ops, 500)) is None


def test_no_number_from_a_program_without_the_recorder_or_with_drops(
        bench, monkeypatch):
    _record(monkeypatch, ROUND_SPANS)
    monkeypatch.setattr(profiling, "summary", lambda: {
        "flow.spline": {"count": 9, "total_s": 0.0, "self_s": 0.0,
                        "dropped": 1}})
    tr = _trace(ROUND_OPS, 1000)
    for metric in ROUND_METRICS:
        assert _read(bench, metric, tr) is None
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "trace_us")
    for metric in ROUND_METRICS:
        assert _read(bench, metric, tr) is None


def test_the_new_entries_load_through_the_loader(bench):
    rounds = ("a1_n3_round_c64k", "n8_transformer_round_c16k")
    blocks = ("a1_n3_mcmc_f1000_c16k", "n8_mcmc_f1000_c16k")
    for cell in rounds + blocks:
        names = {m["name"] for m in bench.per_layer(cell)}
        assert (set(ROUND_METRICS) <= names) == (cell in rounds)
        assert (BLOCK_METRIC in names) == (cell in blocks)
    for metric in ROUND_METRICS + (BLOCK_METRIC,):
        entry = next(m for m in bench.spec["per_layer"]
                     if m["name"] == metric)
        assert entry["source"] == "device_trace"
        assert callable(bench.reader(metric))
