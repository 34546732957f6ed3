"""Nothing the benchmark runs imports JAX, the JAX package or the root
``bench.py``, by whole top-level names (``flowstate_tpu_torch`` begins
with ``flowstate_tpu``, and is not it); the reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.standin import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "flowstate_tpu", "bench"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch",
                    "benchmark"}
    assert all(name.startswith("benchmark.reference")
               for name in _imports(path) if name.startswith("benchmark"))


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "flowstate_tpu_torch_x", sys)
    assert "flowstate_tpu" not in harness.forbidden_modules() or \
        "flowstate_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the benchmark and the program's entries it drives,
    imported in a fresh process, leave JAX and the JAX package out."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.harness, benchmark.trace\n"
        "import benchmark.calibrate, benchmark.faults\n"
        "from benchmark.loader import Benchmark\n"
        "b = Benchmark(%r)\n"
        "for t in ('rounds', 'production'): b.driver(t)\n"
        "for m in b.spec['per_layer']: b.reader(m['name'])\n"
        "import flowstate_tpu_torch.experiments.algorithm1\n"
        "import flowstate_tpu_torch.mcmc.cuda_metropolis\n"
        "from benchmark.harness import forbidden_modules\n"
        "print(forbidden_modules())\n") % (REPO, REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_a_module_loaded_by_the_check_stops_the_run(monkeypatch, tmp_path):
    """The look for JAX comes after the check and its verdict: a module
    that either loads leaves the run without a result."""
    import time

    from benchmark.loader import Benchmark
    from benchmark.tests.standin import philox_k1, tiny_root

    bench = Benchmark(tiny_root(str(tmp_path)))
    judge = harness.judge

    def loading_judge(numbers, limits):
        sys.modules.setdefault("jaxlib.fake", sys)
        return judge(numbers, limits)

    monkeypatch.setattr(harness, "judge", loading_judge)
    monkeypatch.delitem(sys.modules, "jaxlib.fake", raising=False)
    with philox_k1(), pytest.raises(RuntimeError, match="jaxlib"):
        harness.run_cell(bench, "tiny_residual.mcmc", 7, 0.2, False, "cpu",
                         time.perf_counter())
    sys.modules.pop("jaxlib.fake", None)
