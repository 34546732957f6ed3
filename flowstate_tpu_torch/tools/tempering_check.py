"""ΔF of the double-well LJ system by parallel tempering, no flow at all.

Port of ``tools/tempering_check.py``, the command behind TEMPERING.md's
table: a replica-exchange ensemble (10 replicas, T from 1 to 10
geometric) whose every walker starts with all three particles in well A
must carry the hot replicas' barrier crossings down to the beta = 1
replica and reproduce the exact ΔF = ln P(all B) / P(all A) = 1.490.  The
run is ``mcmc.tempering.run_replica_exchange`` on the card: one launch of
the move kernel over all replicas x walkers a round, then the swap, every
round's energies and well counts recorded on the device.

It prints one JSON line: the cold replica's ΔF with its SEM over 4
blocks, the MBAR ΔF pooling every replica, the particle-level ΔF
ln(sum n_B / sum n_A) of the cold replica and by MBAR (the tempering
driver's thinning and 5-block SEM), the sector fractions, the edge
acceptance and the run's wall seconds; on the card also ms per round by
the host clock and, from a profiled window of 50 rounds, device kernels
and device ms per round and the idle share 1 - device ms / ms; beside
them the JAX package's numbers.  It writes the line's JSON to
``--evidence`` and never writes TEMPERING.md.

    python -m flowstate_tpu_torch.tools.tempering_check
    python -m flowstate_tpu_torch.tools.tempering_check --num_particles 8 \\
        --walkers 51 --moves_per_round 150 --rounds 600

At N = 3 every walker starts with its three particles in well A and
there is no equilibration, as in the JAX tool.  At any other N the run
starts as the tempering driver's does (``experiments.tempering.
initial_state``), as the JAX driver's run at N = 8 did: the
alternating-well batch on every replica, then every replica equilibrated
at its own beta for the driver's default number of moves.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from flowstate_tpu_torch.analysis.mbar import pt_well_delta_f
from flowstate_tpu_torch.analysis.wells import classify_particles
from flowstate_tpu_torch.experiments.common import build_system, device_name
from flowstate_tpu_torch.experiments.tempering import (
    default_equilibration_steps, initial_state, mbar_well_delta_f,
    well_record,
)
from flowstate_tpu_torch.mcmc.tempering import (
    run_replica_exchange, temperature_ladder,
)
from flowstate_tpu_torch.utils.config import tempering_config

EXACT_DF = 1.490  # tools/exact_free_energy.py, M=4e6
EXACT_SECTORS = {"AAA": 0.0378, "AAB": 0.3011, "ABB": 0.4939, "BBB": 0.1672}
# the JAX package's numbers for the same commands: TEMPERING.md's table
# (N=3) and the driver's N=8 run (results/evidence/pt_n8_r5_data.json)
JAX_REFERENCE = {
    3: {"value": 1.4911, "sem": 0.0529, "mbar_all_replicas": 1.5019,
        "sector_fracs": {"AAA": 0.0371, "AAB": 0.3058, "ABB": 0.4907,
                         "BBB": 0.1649},
        "edge_acceptance": [0.633, 0.892],
        "source": "TEMPERING.md (tools/tempering_check.py, TPU v5e)"},
    8: {"df_particle_mbar": 0.0641, "df_particle_mbar_sem": 0.0046,
        "df_particle_cold": 0.0648,
        "source": "results/evidence/pt_n8_r5_data.json (the tempering "
                  "driver, 51 walkers x 10 replicas, 600 rounds of 150 "
                  "moves, TPU v5e)"},
}
SEED = 11   # the chains' Philox seed; the swaps' generator takes SEED + 1
PROFILE_ROUNDS = 50   # rounds of the profiled window on the card


def all_in_a(spec, walkers: int) -> np.ndarray:
    """(W, 3, 2): the JAX tool's start, every particle in well A."""
    lx, ly = spec.box.size_x, spec.box.size_y
    base = np.array([[lx / 4, ly / 2], [lx / 4 + 1.1, ly / 2],
                     [lx / 4 - 0.6, ly / 2 + 0.9]], dtype=np.float32)
    return np.tile(base, (walkers, 1, 1))


def profile_rounds(spec, betas, state, generator, moves_per_round: int,
                   record_fn, rounds: int = PROFILE_ROUNDS) -> dict:
    """ms per round by the host clock over ``rounds`` rounds, then device
    kernels and device ms per round from a profiled window of as many, and
    the idle share 1 - device ms / ms.  The state is not returned."""
    from torch.profiler import ProfilerActivity, profile

    def go():
        run_replica_exchange(spec, betas, state, generator, rounds,
                             moves_per_round, record_fn=record_fn)
        torch.cuda.synchronize()

    go()                                         # warm
    t0 = time.perf_counter()
    go()
    ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        go()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                 / rounds if kernels else None)
    return {"ms_per_round": ms,
            "kernels_per_round": len(kernels) / rounds if kernels else None,
            "device_ms_per_round": device_ms,
            "idle_share": 1.0 - device_ms / ms if kernels else None}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_particles", type=int, default=3)
    parser.add_argument("--walkers", type=int, default=256)
    parser.add_argument("--replicas", type=int, default=10)
    parser.add_argument("--t_hot", type=float, default=10.0)
    parser.add_argument("--rounds", type=int, default=3000)
    parser.add_argument("--moves_per_round", type=int, default=50)
    parser.add_argument("--seed", type=int, default=SEED,
                        help="the chains' seed; the swaps draw from seed + 1")
    parser.add_argument("--evidence", default=os.path.join(
        "results", "evidence", "tempering_check_torch_data.json"))
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    n = args.num_particles
    equil = 0 if n == 3 else default_equilibration_steps(n)
    config = tempering_config(
        num_chains=args.walkers, num_particles=n,
        pt_replicas=args.replicas, pt_t_hot=args.t_hot,
        pt_moves_per_round=args.moves_per_round, master_seed=args.seed,
        equilibration_steps=equil)
    spec = build_system(config)
    lx = spec.box.size_x
    betas = temperature_ladder(1.0, args.t_hot, args.replicas,
                               device=device)
    state = initial_state(config, spec, betas,
                          all_in_a(spec, args.walkers) if n == 3 else None)
    record_fn = well_record(config)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run_replica_exchange(spec, betas, state, generator, args.rounds,
                                  args.moves_per_round, record_fn=record_fn)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cold = result.cold_positions.cpu().numpy()            # (T, W, N, 2)
    na_all, nb_all, e_all = (x.cpu().numpy() for x in result.extras)
    edge_acc = result.edge_acceptance.cpu().numpy()

    burn = args.rounds // 3
    frames = cold[burn:].reshape(-1, n, 2)
    labels = classify_particles(frames, lx / 2, r0=spec.r0)
    all_a = np.all(labels == 0, axis=-1)
    all_b = np.all(labels == 1, axis=-1)
    df = float(np.log(max(all_b.sum(), 1) / max(all_a.sum(), 1)))
    # SEM over four blocks of the cold frames
    dfs = [np.log(max(b.sum(), 1) / max(a.sum(), 1))
           for a, b in zip(np.array_split(all_a, 4),
                           np.array_split(all_b, 4))]
    sem = float(np.std(dfs) / np.sqrt(len(dfs)))
    n_b_per = (labels == 1).sum(axis=-1)
    sector = np.where((labels == 2).any(axis=-1), n + 1, n_b_per)
    fracs = [float((sector == k).mean()) for k in range(n + 2)]
    names = (["AAA", "AAB", "ABB", "BBB"] if n == 3
             else [f"{k}B" for k in range(n + 1)])
    sector_fracs = {name: round(f, 4) for name, f in zip(names, fracs)}
    sector_fracs["outside"] = round(fracs[-1], 4)

    # MBAR over every replica (the JAX tool's: all post-burn rounds), and
    # the driver's particle-level analysis
    t_post, r, w = e_all[burn:].shape
    pooled = lambda a: np.transpose(a[burn:], (1, 0, 2))  # noqa: E731
    df_mbar, _ = pt_well_delta_f(
        torch.as_tensor(pooled(e_all).reshape(r, t_post * w),
                        device=device), betas,
        torch.as_tensor(pooled(na_all).reshape(-1) == n, device=device),
        torch.as_tensor(pooled(nb_all).reshape(-1) == n, device=device))
    particle = mbar_well_delta_f(betas, na_all, nb_all, e_all, n, burn)
    df_cold = float(np.log(max(nb_all[burn:, 0].sum(), 1.0)
                           / max(na_all[burn:, 0].sum(), 1.0)))

    timing = {}
    if device.type == "cuda":
        timing = profile_rounds(
            spec, betas, result.state,
            torch.Generator(device=device).manual_seed(args.seed + 2),
            args.moves_per_round, record_fn)
    summary = {
        "metric": "pt_delta_f",
        "device": device_name(device),
        "num_particles": n,
        "seed": args.seed,
        "equilibration_steps": equil,
        "value": round(df, 4),
        "sem": round(sem, 4),
        "mbar_all_replicas": round(df_mbar, 4),
        "df_particle_cold": round(df_cold, 4),
        "df_particle_mbar": round(particle["df_particle_mbar"], 4),
        "df_particle_mbar_sem": round(particle["df_particle_mbar_sem"], 4),
        "mbar_pooled_samples": particle["pooled"],
        "exact": EXACT_DF if n == 3 else None,
        "edge_acceptance_min": round(float(edge_acc.min()), 4),
        "edge_acceptance_max": round(float(edge_acc.max()), 4),
        "edge_acceptance": [round(float(a), 4) for a in edge_acc],
        "replicas": args.replicas,
        "walkers": args.walkers,
        "rounds": args.rounds,
        "moves_per_round": args.moves_per_round,
        "cold_frames_used": int(len(frames)),
        "sector_fracs": sector_fracs,
        "exact_sector_fracs": EXACT_SECTORS if n == 3 else None,
        "wall_s": wall_s,
        "ms_per_round_run": wall_s * 1e3 / args.rounds,
        **timing,
        # the profiled window's device ms per round times the rounds
        "device_s_est": (timing["device_ms_per_round"] * args.rounds / 1e3
                         if timing.get("device_ms_per_round") else None),
        "jax": JAX_REFERENCE.get(n),
    }
    if args.evidence:
        os.makedirs(os.path.dirname(os.path.abspath(args.evidence)),
                    exist_ok=True)
        with open(args.evidence, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
