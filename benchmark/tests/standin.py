"""What the CPU tests put in place of the card: a move kernel that keeps
the kernel's documented random stream (the program's plain engine fed
with the reference's Philox draws), and a benchmark root of tiny cells
(K=2 couplings of width 16, 32 chains, 20 moves a round) copied from the
real one with its own entries."""

from __future__ import annotations

import contextlib
import json
import os
import shutil

import numpy as np
import torch

from benchmark.reference.metropolis import draws

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def philox_k1():
    """The program's plain move engine drawing the move kernel's stream."""
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm

    original = cm.run_moves_plain

    def moves(spec, beta, state, num_moves, tables=None, margin_log=None):
        if tables is None:
            c = state.positions.shape[0]
            p, ux, uy, ua = draws(state.seed & 0xFFFFFFFF, np.arange(c),
                                  state.calls, num_moves, spec.num_particles)
            tables = (torch.as_tensor(p, dtype=torch.int32),
                      torch.as_tensor(np.stack([ux, uy], -1),
                                      dtype=torch.float32),
                      torch.as_tensor(ua, dtype=torch.float32))
        return original(spec, beta, state, num_moves, tables, margin_log)

    cm.run_moves_plain = moves
    try:
        yield
    finally:
        cm.run_moves_plain = original


def tiny_config(name: str, n: int, net: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs",
                           "a1_n3_residual.json")) as f:
        config = json.load(f)
    config.update(name=name)
    config["system"]["num_particles"] = n
    config["flow"].update(K=2, hidden_units=16, num_bins=4, net_type=net,
                          num_heads=4)
    config["schedule"].update(big_move_interval=20, equilibration_steps=40,
                              adjusting_frequency=20)
    config.pop("parameters")
    return config


def tiny_root(tmp: str) -> str:
    """A copy of the benchmark under ``tmp`` with four tiny cells added as
    files and entries, none of the copied files edited."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = os.path.join(root, "benchmark")
    for name, n, net in (("tiny_residual", 3, "residual"),
                         ("tiny_transformer", 4, "transformer")):
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(root, path), "w") as f:
            json.dump(tiny_config(name, n, net), f)
        spec["configs"].append({"name": name, "source": "a test",
                                "file": path, "reduced": [], "why": "a test"})
    traffic = {
        "tiny_rounds": {"driver": "rounds", "chains": 32,
                        "rounds_per_chunk": 2,
                        "check": {"chunks": 2, "k1_chains": 16,
                                  "block": 16}},
        "tiny_mcmc": {"driver": "production", "chains": 32,
                      "moves_per_sample": 20, "samples_per_chunk": 3,
                      "check": {"k1_chains": 16}}}
    for name, t in traffic.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(REPO, "benchmark", "limits",
                           "a1_n3_round_c64k.json")) as f:
        round_limits = json.load(f)
    with open(os.path.join(REPO, "benchmark", "limits",
                           "a1_n3_mcmc_f1000_c16k.json")) as f:
        mcmc_limits = json.load(f)
    for config in ("tiny_residual", "tiny_transformer"):
        for kind, limits in (("rounds", round_limits), ("mcmc", mcmc_limits)):
            cell = f"{config}.{kind}"
            spec["workloads"].append({"name": cell, "config": config,
                                      "traffic": f"tiny_{kind}", "chips": 1,
                                      "why": "a test"})
            with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as f:
                json.dump(limits, f)
            metric = ("big_moves_per_s" if kind == "rounds"
                      else "mc_moves_per_s")
            for m in spec["end_to_end"]:
                if m["name"] == metric:
                    m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
