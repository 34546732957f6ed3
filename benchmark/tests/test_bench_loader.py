"""A configuration, a cell, a traffic mix and a per-layer metric are
added as files and entries, with no file of the benchmark edited; the
loader finds each by its name."""

import hashlib
import json
import os
import types

from benchmark.loader import Benchmark
from benchmark.tests.standin import tiny_root


def _digests(top):
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            if "__pycache__" in dirpath:
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_new_parts_are_files_and_entries(tmp_path):
    root = tiny_root(str(tmp_path))
    before = _digests(os.path.join(root, "benchmark"))
    with open(os.path.join(root, "benchmark", "metrics",
                           "chains_per_kernel.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.traffic['chains'] / ctx.traced['units']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "chains_per_kernel", "unit": "chains", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "big_moves_per_s", "workloads": ["tiny_residual.rounds"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _digests(os.path.join(root, "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before

    bench = Benchmark(root)
    assert bench.config("tiny_transformer")["flow"]["net_type"] == \
        "transformer"
    assert bench.traffic(bench.cell("tiny_residual.mcmc")["traffic"])[
        "driver"] == "production"
    assert set(bench.limits("tiny_residual.rounds")) >= {"logq_gap", "k1_gap"}
    assert [m["name"] for m in bench.end_to_end("tiny_residual.rounds")] == \
        ["big_moves_per_s", "setup_s"]
    per_layer = [m["name"] for m in bench.per_layer("tiny_residual.rounds")]
    assert "chains_per_kernel" in per_layer
    assert "k1_roofline" not in per_layer
    read = bench.reader("chains_per_kernel")
    ctx = types.SimpleNamespace(traffic={"chains": 32}, traced={"units": 2})
    assert read(ctx) == 16


def test_the_real_benchmark_loads_every_part():
    from benchmark.tests.standin import REPO

    bench = Benchmark(REPO)
    for cell in bench.spec["workloads"]:
        bench.config(cell["config"])
        traffic = bench.traffic(cell["traffic"])
        bench.driver(traffic["driver"])
        assert bench.limits(cell["name"])
        reported = [m["name"] for m in bench.end_to_end(cell["name"])]
        assert "setup_s" in reported and len(reported) == 2
        for m in bench.per_layer(cell["name"]):
            bench.reader(m["name"])
        assert bench.per_layer(cell["name"])
