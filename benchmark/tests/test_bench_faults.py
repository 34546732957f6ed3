"""A run of each tiny cell on the CPU, with the move kernel's documented
stream standing in for the card: sound, it comes out correct; with a
fault planted in the program under the timed path (a step that leaves
the state unchanged, half of the chains left out, an answer altered
where it is produced, a verdict that takes every proposal), it comes
out not correct."""

import time

import pytest

from benchmark import faults
from benchmark.harness import run_cell
from benchmark.loader import Benchmark
from benchmark.tests.standin import philox_k1, tiny_root

CELLS = {"tiny_residual.rounds": ("frozen", "half", "altered_positions",
                                  "altered_logq", "always_accept"),
         "tiny_transformer.rounds": ("altered_logq", "always_accept"),
         "tiny_residual.mcmc": ("frozen", "half", "altered_positions",
                                "altered_energy"),
         "tiny_transformer.mcmc": ("half",)}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return Benchmark(tiny_root(str(tmp_path_factory.mktemp("bench"))))


def _run(bench, cell, seed):
    with philox_k1():
        return run_cell(bench, cell, seed, 0.3, False, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(bench, cell):
    result = _run(bench, cell, 2 ** 31 + 99)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", sorted(
    (cell, fault) for cell, names in CELLS.items() for fault in names))
def test_a_fault_makes_the_run_not_correct(bench, cell, fault):
    with faults.planted(fault, "cpu"):
        result = _run(bench, cell, 4242)
    assert not result["correct"], result["checks"]
