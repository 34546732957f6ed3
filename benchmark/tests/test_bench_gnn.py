"""The torus EGNN's cell on the CPU: a tiny gnn stand-in cell (K=2
couplings of width 16, 32 chains, 20 moves a round, at a temperature
where the verdicts turn on log q), added as files and entries as
``standin.py`` adds the others, comes out correct when sound and not
correct with the log q or the verdict's log q term altered; the real
cell's flow, at its widths and with its weights' draw, keeps the
program's float32 log q well inside the cell's limit; a chunk
counts the messages ``gnn_messages_roofline`` requires; the message
readers on a hand-written trace; the cell's driver and readers load
without JAX."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from benchmark import counts, faults, gnn_counts
from benchmark.harness import run_cell
from benchmark.loader import Benchmark
from benchmark.tests.standin import REPO, philox_k1, tiny_config, tiny_root
from benchmark.tests.test_bench_program_spans import _record, _trace

CELL = "tiny_gnn.rounds"


def gnn_root(tmp: str) -> str:
    """``tiny_root`` with a tiny gnn cell added as files and entries."""
    root = tiny_root(tmp)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    path = "benchmark/configs/tiny_gnn.json"
    config = tiny_config("tiny_gnn", 4, "gnn")
    config["flow"].pop("num_heads")
    # hot, so that the verdicts turn on log q and a flipped log q shows
    config["system"]["temperature"] = 1000.0
    with open(os.path.join(root, path), "w") as f:
        json.dump(config, f)
    spec["configs"].append({"name": "tiny_gnn", "source": "a test",
                            "file": path, "reduced": [], "why": "a test"})
    with open(os.path.join(bench, "traffic", "tiny_gnn_rounds.json"),
              "w") as f:
        json.dump({"driver": "gnn_rounds", "chains": 32,
                   "rounds_per_chunk": 2,
                   "check": {"chunks": 2, "k1_chains": 16, "block": 16}}, f)
    with open(os.path.join(REPO, "benchmark", "limits",
                           "n8_gnn_round_c16k.json")) as f:
        limits = json.load(f)
    with open(os.path.join(bench, "limits", f"{CELL}.json"), "w") as f:
        json.dump(limits, f)
    spec["workloads"].append({"name": CELL, "config": "tiny_gnn",
                              "traffic": "tiny_gnn_rounds", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "big_moves_per_s":
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Benchmark(gnn_root(str(tmp_path_factory.mktemp("bench"))))


def _run(bench, seed):
    with philox_k1():
        return run_cell(bench, CELL, seed, 0.3, False, "cpu",
                        time.perf_counter())


def test_a_sound_run_is_correct(bench):
    result = _run(bench, 2 ** 31 + 99)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"]["logq_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["altered_logq", "flipped_logq"])
def test_a_fault_makes_the_run_not_correct(bench, fault):
    with faults.planted(fault, "cpu"):
        result = _run(bench, 4242)
    assert not result["correct"], result["checks"]


@pytest.fixture(scope="module")
def real_cell():
    """The real gnn cell's configuration, traffic and ``logq_gap`` limit."""
    real = Benchmark(REPO)
    cell = real.cell("n8_gnn_round_c16k")
    return (real.config(cell["config"]), real.traffic(cell["traffic"]),
            real.limits("n8_gnn_round_c16k")["logq_gap"])


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_the_real_cells_flow_keeps_its_float32_log_q_gap_small(real_cell,
                                                               seed):
    """The cell's flow (K=15, hidden 64, 2 layers, 32 bins, N=8) with the
    configuration's weights: the program's float32 log q of 256 samples,
    from ``sample_and_log_prob`` and from ``log_prob``, within a quarter
    of the cell's ``logq_gap`` limit of the reference's float64 log q, so
    that a draw whose random flow amplifies float32 rounding fails here
    before the card's check meets it on some seed."""
    import torch

    from benchmark import gnn_weights
    from benchmark.drivers import common, rounds
    from benchmark.reference import egnn as ref_egnn
    from flowstate_tpu_torch.flows import build_circular_flow

    config, traffic, limit = real_cell
    f = config["flow"]
    cfg = common.experiment_config(config, traffic, seed)
    model = build_circular_flow(
        cfg.num_particles, 2, cfg.half_box, K=f["K"],
        hidden_units=f["hidden_units"], num_bins=f["num_bins"],
        num_blocks=f["n_blocks"], net_type=f["net_type"], device="cpu")
    weights = gnn_weights.make(f, config["init"], cfg.dim, seed, "cpu")
    rounds.load_weights(model, weights)
    g = torch.Generator()
    g.manual_seed(seed)
    with torch.no_grad():
        x, logq_new = model.sample_and_log_prob(256, g)
        logq_old = model.log_prob(x)
        ref = ref_egnn.log_prob(
            gnn_weights.tree_map(lambda t: t.double(), weights), x.double(),
            cfg.half_box, f["hidden_units"], f["num_bins"]).numpy()
    gap = max(common.max_gap(logq_new.numpy(), ref),
              common.max_gap(logq_old.numpy(), ref))
    assert gap <= limit / 4, (gap, limit)


def test_the_residual_nets_bf16_is_refused(bench):
    cell = bench.cell(CELL)
    driver = bench.driver(bench.traffic(cell["traffic"])["driver"])
    with pytest.raises(ValueError, match="bfloat16"):
        driver.Session(bench.config("tiny_gnn"), bench.traffic(
            cell["traffic"]), 1, "cpu", control="bf16")


def test_a_chunk_counts_every_message_the_roofline_requires(bench):
    from flowstate_tpu_torch.flows import nets

    cell = bench.cell(CELL)
    config, traffic = bench.config("tiny_gnn"), bench.traffic(cell["traffic"])
    with philox_k1():
        session = bench.driver(traffic["driver"]).Session(
            config, traffic, 3, "cpu")
        before = nets.GNN_MESSAGES
        session._chunk()
    want = (2 * gnn_counts.messages(config["flow"], 8, traffic["chains"])
            * traffic["rounds_per_chunk"])
    assert nets.GNN_MESSAGES - before == want == 2 * 2 * 32 * 12 * 2 * 2


# a round on the trace's clock (µs): (id, name, parent, start, end)
SPANS = [
    (1, "a1.round", None, 10, 900),
    (2, "mcmc.moves", 1, 20, 60),
    (3, "flow.sample_and_log_prob", 1, 100, 400),
    (4, "flow.net", 3, 110, 300),
    (5, "flow.gnn.messages", 4, 120, 280),
    (6, "hybrid.verdict", 1, 420, 800),
    (7, "pair.energy", 6, 430, 450),
    (8, "flow.log_prob", 6, 500, 780),
    (9, "flow.net", 8, 510, 700),
    (10, "flow.gnn.messages", 9, 520, 690),
]
OPS = [
    ("metropolis_moves_kernel", 30, 40, 100),
    ("sgemm", 115, 115, 130),                 # the embedding, outside
    ("cat", 125, 130, 170),                   # in flow.gnn.messages
    ("sgemm", 200, 200, 290),                 # in flow.gnn.messages
    ("pair_group_kernel", 440, 440, 460),
    ("sgemm", 600, 600, 650),                 # in flow.gnn.messages
    ("sgemm", 695, 695, 700),                 # the mean and final, outside
]


def _ctx(bench, messages):
    config = {"flow": {"K": 15, "hidden_units": 64, "n_blocks": 2,
                       "num_bins": 32, "net_type": "gnn"},
              "system": {"num_particles": 8}}
    return types.SimpleNamespace(
        config=config, traffic={"chains": 16384}, trace=_trace(OPS, 1000),
        traced={"units": 1, "gnn_messages": messages})


def test_the_message_readers(bench, monkeypatch):
    _record(monkeypatch, SPANS)
    f = {"K": 15, "hidden_units": 64, "n_blocks": 2, "num_bins": 32,
         "net_type": "gnn"}
    every = 2 * gnn_counts.messages(f, 16, 16384)
    ms = (40 + 90 + 50) / 1e3
    assert bench.reader("gnn_messages_ms_per_round")(_ctx(bench, every)) == \
        pytest.approx(ms, abs=1e-12)
    layers = 2 * 15 * 2 * 16384
    bound = max(layers * gnn_counts.layer_flops(8, 64) / counts.PEAK_FP32_FLOPS,
                layers * gnn_counts.layer_bytes(8, 64) / counts.PEAK_BYTES_PER_S)
    assert bench.reader("gnn_messages_roofline")(_ctx(bench, every)) == \
        pytest.approx(100 * bound / (ms / 1e3), rel=1e-12)
    for short in (None, every - 1):
        assert bench.reader("gnn_messages_roofline")(_ctx(bench, short)) is None


def test_the_gnn_cells_driver_and_readers_load_without_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.loader import Benchmark\n"
        "b = Benchmark(%r)\n"
        "b.driver('gnn_rounds')\n"
        "for m in b.per_layer('n8_gnn_round_c16k'): b.reader(m['name'])\n"
        "import benchmark.reference.egnn, benchmark.gnn_weights\n"
        "from benchmark.harness import forbidden_modules\n"
        "print(forbidden_modules())\n") % (REPO, REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"
