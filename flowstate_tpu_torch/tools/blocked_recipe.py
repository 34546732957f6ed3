"""The JAX package's blocked runs at N=8, repeated by the port.

``--driver a1`` runs Algorithm 1 with ``blocked_k=1`` at the configuration
of ``results/evidence/a1_blocked_n8_local_data.json`` (510 chains, 102,000
training samples, 30 epochs, 400 rounds of 150 local moves and 8 blocked
moves); ``--driver a2`` runs Algorithm 2's host loop at that of
``results/evidence/a2_blocked_n8_data.json`` (255 chains, 100 cycles).
Both files' ``config`` block is read as data; ``blocked_K`` is set to 10,
the depth those runs had (they predate the knob).  Prints one JSON line:
the card's name and power limit, the port's acceptance, final loss (the
last epoch's mean of Phase C in A1, the last cycle's in A2), sector
histogram and its peak, the particle-level ΔF and each phase's wall
beside the JAX file's numbers (its final loss where the file has one),
the PT oracle's ΔF (``results/evidence/blocked_depth.json``) and whether
each number lies in the range the port is expected to read.

    python -m flowstate_tpu_torch.tools.blocked_recipe --driver a1 \\
        [--output_dir .blocked_recipe_out] [--evidence PATH] [--seed S] \\
        [--device cuda]

``--seed`` replaces the evidence file's ``master_seed`` (42) to repeat the
run on other draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from flowstate_tpu_torch.analysis.wells import classify_particles
from flowstate_tpu_torch.experiments import algorithm1, algorithm2
from flowstate_tpu_torch.tools.common import card
from flowstate_tpu_torch.utils.config import ExperimentConfig

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EVIDENCE = {"a1": "a1_blocked_n8_local_data.json",
            "a2": "a2_blocked_n8_data.json"}
# where the port's numbers are expected to land: near the JAX runs'
# acceptance (A1 0.2846; A2 0.201 at cycle 100), the histogram's peak at
# 4B, and the particle-level ΔF near the PT oracle's 0.0546
EXPECTED = {"a1_acceptance": (0.25, 0.32), "a2_acceptance": (0.17, 0.23),
            "df_particle": (0.03, 0.07), "peak": "4B"}


def jax_config(name: str) -> dict:
    """The evidence file's ``config`` block, less what the run sets."""
    with open(os.path.join(REPO, "results", "evidence", name)) as f:
        doc = json.load(f)
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    cfg = {k: v for k, v in doc["config"].items() if k in fields}
    cfg["V0_list"] = tuple(cfg["V0_list"])
    for k in ("experiment_id", "output_dir"):
        cfg.pop(k)
    return doc, cfg


def sectors(counts: dict) -> dict:
    """The histogram's peak and the particle-level ΔF its in-well
    configurations give, ln(sum k c_kB / sum (N - k) c_kB)."""
    ks = [int(k[:-1]) for k in counts if k.endswith("B")]
    n = max(ks)
    c = {k: counts[f"{k}B"] for k in ks}
    n_b = sum(k * v for k, v in c.items())
    n_a = sum((n - k) * v for k, v in c.items())
    return {"peak": f"{max(c, key=c.get)}B",
            "df_in_well": float(np.log(max(n_b, 1) / max(n_a, 1)))}


def particle_df(traj: np.ndarray, half_box: float, r0: float) -> float:
    """ln(n_B / n_A) over the second half of every chain of a (C, T, N, 2)
    trajectory, as Algorithm 1's ``df_particle``."""
    lab = classify_particles(traj[:, traj.shape[1] // 2:], half_box, r0)
    return float(np.log(max(float(np.sum(lab == 1)), 1.0)
                        / max(float(np.sum(lab == 0)), 1.0)))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--driver", choices=("a1", "a2"), required=True)
    parser.add_argument("--output_dir", type=str,
                        default=".blocked_recipe_out")
    parser.add_argument("--evidence", type=str, default=None,
                        help="also write the JSON line to this file")
    parser.add_argument("--seed", type=int, default=None,
                        help="master_seed (default: the evidence file's)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    doc, cfg = jax_config(EVIDENCE[args.driver])
    if args.seed is not None:
        cfg["master_seed"] = args.seed
    config = ExperimentConfig(
        **{**cfg, "blocked_K": 10,
           "experiment_id": f"blocked_recipe_torch_{args.driver}",
           "output_dir": args.output_dir})
    t0 = time.perf_counter()
    if args.driver == "a1":
        res = algorithm1.run(config, device=args.device)
    else:
        res = algorithm2.run(config, device=args.device)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(args.output_dir, "evidence",
                           f"{config.experiment_id}_data.json")) as f:
        ours = json.load(f)
    port = {"acceptance": float(res["big_move_acceptance"]),
            "sector_counts": ours["sector_counts"],
            **sectors(ours["sector_counts"]),
            "phase_s": res["phase_s"], "wall_s": wall_s}
    jax_side = {"acceptance": doc["big_move_acceptance"],
                "sector_counts": doc["sector_counts"],
                **sectors(doc["sector_counts"]), "device": doc["device"]}
    if args.driver == "a1":
        port["df_particle"] = res["df_particle"]
        port["final_loss"] = res["final_loss"]
    else:
        port["final_loss"] = res["loss_per_cycle"][-1]
        jax_side["final_loss"] = doc["loss_per_cycle"][-1]
        hist = res["p_acc_history"]
        port["acceptance_cycle_1"] = hist[1]
        jax_side["acceptance_cycle_1"] = doc["p_acc_history"][1]
        traj = np.load(os.path.join(res["directory"],
                                    "production_positions.npy"))
        port["df_particle"] = particle_df(traj, config.half_box, config.r0)
    with open(os.path.join(REPO, "results", "evidence",
                           "blocked_depth.json")) as f:
        pt_df = json.load(f)["pt"]["df_particle"]
    lo, hi = EXPECTED[f"{args.driver}_acceptance"]
    in_range = {
        "acceptance": lo <= port["acceptance"] <= hi,
        "peak": port["peak"] == EXPECTED["peak"],
        "df_particle": (EXPECTED["df_particle"][0] <= port["df_particle"]
                        <= EXPECTED["df_particle"][1])}
    line = {"card": card(args.device), "driver": args.driver,
            "chains": config.num_chains,
            "num_particles": config.num_particles,
            "master_seed": config.master_seed,
            "blocked_K": config.blocked_K, "port": port, "jax": jax_side,
            "pt_df_particle": pt_df, "expected": EXPECTED,
            "in_range": in_range}
    print(json.dumps(line), flush=True)
    if args.evidence:
        os.makedirs(os.path.dirname(os.path.abspath(args.evidence)),
                    exist_ok=True)
        with open(args.evidence, "w") as f:
            json.dump(line, f, indent=1)
    return line


if __name__ == "__main__":
    main()
