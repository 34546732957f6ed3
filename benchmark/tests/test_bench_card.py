"""On the card: the check's control, at a size a test run holds (the
cells' configurations and limits, 4,096 chains).  A sound run is
correct; the control is not: float32 products on TF32 tensor cores, and
the reference in bfloat16 in the program's place for the move kernel's
positions and the pair energies."""

import json
import os
import time

import pytest

from benchmark.calibrate import tf32
from benchmark.harness import run_cell
from benchmark.loader import Benchmark
from benchmark.tests.standin import tiny_root

ROUNDS = {"driver": "rounds", "chains": 4096, "rounds_per_chunk": 2,
          "check": {"chunks": 2, "k1_chains": 128, "block": 4096}}
MCMC = {"driver": "production", "chains": 4096, "moves_per_sample": 1000,
        "samples_per_chunk": 10, "check": {"k1_chains": 128}}
CELLS = {"a1_small.rounds": ("a1_n3_residual", "a1_n3_round_c64k", ROUNDS),
         "a1_small.mcmc": ("a1_n3_residual", "a1_n3_mcmc_f1000_c16k", MCMC),
         "n8_small.rounds": ("n8_transformer", "n8_transformer_round_c16k",
                             ROUNDS),
         "n8_small.mcmc": ("n8_transformer", "n8_mcmc_f1000_c16k", MCMC)}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tiny_root(str(tmp_path_factory.mktemp("bench")))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell, (config, limits_of, traffic) in CELLS.items():
        with open(os.path.join(root, "benchmark", "traffic",
                               f"{cell}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(root, "benchmark", "limits",
                               f"{limits_of}.json")) as f:
            limits = json.load(f)
        with open(os.path.join(root, "benchmark", "limits",
                               f"{cell}.json"), "w") as f:
            json.dump(limits, f)
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": cell, "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return Benchmark(root)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(card, bench, cell):
    result = run_cell(bench, cell, 2 ** 31 + 5, 1.0, False, card,
                      time.perf_counter())
    assert result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(card, bench, cell):
    with tf32(True):
        result = run_cell(bench, cell, 17, 1.0, False, card,
                          time.perf_counter(), control="lower")
    assert not result["correct"], result["checks"]
