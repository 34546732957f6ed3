"""Within-well decorrelation: Metropolis, MALA and HMC at their own job.

Port of ``tools/within_well_bench.py`` (SAMPLERS.md's within-well
section).  One well only (num_wells 1, V0 -10, nothing to cross), chains
equilibrated in it, and the ESS/s of the fast observables, energy per
particle and the mean x, of the three local samplers at each N.  A round
is, per chain:

  Metropolis  50 N single-particle moves (one move-kernel launch)
  MALA        25 whole-configuration moves (2 gradients each)
  HMC         4 trajectories of 10 leapfrog steps (11 gradients each)

MALA's and HMC's proposal energies go through the pair-energy kernel on
the card; their gradients are autograd of the plain energy.  ESS: the
rank-normalised multichain estimator after a burn of a third.  Each
sampler's rounds are a host loop timed by CUDA events (JAX times one
fused scan), after one untimed warm-up round.

It prints one line a row, the SAMPLERS.md section (``render_section``)
and the section's data as one JSON line; it never splices SAMPLERS.md.
With ``--evidence`` it writes that JSON, which ``tools.sampler_bench``
reads.

    python -m flowstate_tpu_torch.tools.within_well_bench [--rounds 600]
        [--systems 3:1024,32:256,128:64] [--device cuda] [--seed 0]
        [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flowstate_tpu_torch.analysis.ess import multichain_ess
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hmc import run_hmc, run_hmc_equilibration
from flowstate_tpu_torch.mcmc.initialise import (
    initialise_fcc_left_half, initialise_low_left,
)
from flowstate_tpu_torch.mcmc.mala import run_mala, run_mala_equilibration
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, double_well_spec, tool_device,
    write_evidence,
)

SECTION_BEGIN = "<!-- within-well:begin -->"
SECTION_END = "<!-- within-well:end -->"


def _observe(spec, s):
    """(energy/N, mean x) of every chain."""
    return (s.energy / spec.num_particles,
            torch.mean(s.positions[..., 0], dim=-1))


def timed_rounds(spec, move_fn, state, rounds: int, device):
    """One untimed warm-up round, then ``rounds`` rounds of ``move_fn``
    with the observables after each; returns (state, (C, T) energy/N,
    (C, T) mean x, seconds)."""
    move_fn(state)
    es, xs = [], []
    with HostLoopTimer(device) as timer:
        for _ in range(rounds):
            state = move_fn(state)
            e, x = _observe(spec, state)
            es.append(e)
            xs.append(x)
    return (state, torch.stack(es, 1).double().cpu().numpy(),
            torch.stack(xs, 1).double().cpu().numpy(), timer.seconds)


def bench_system(n, chains, rounds, n_leap=10, sweeps_per_round=50,
                 device="cuda", seed=0, mala_equilibration=1000,
                 hmc_equilibration=500):
    """Rows for one particle count."""
    device = tool_device(device)
    spec = double_well_spec(n, num_wells=1, v0=(-10.0,))
    beta = 1.0
    if n <= 12:
        pos, _ = initialise_low_left(n, 0.03)
    else:
        pos, _ = initialise_fcc_left_half(n, 0.03, 1.0)
    g = torch.Generator(device=device).manual_seed(seed + 5)
    pos = torch.as_tensor(np.broadcast_to(pos, (chains, n, 2)).copy(),
                          dtype=torch.float32, device=device)
    # jitter, so that the chains leave the shared lattice start apart
    pos = pos + (torch.rand(pos.shape, generator=g, device=device) - 0.5) * 0.1
    state0 = init_chain_state(spec, pos, seed, 0.65)
    # at least 150 sweeps whatever N
    state0 = run_equilibration(
        spec, beta, state0, max(common.EQUILIBRATION_MOVES, 150 * n), 500,
        move_fn=lambda s, m: run_moves_auto(spec, beta, s, m))
    print(f"N={n}: equilibrated {chains} chains "
          f"(E/N={float(state0.energy.mean()) / n:.2f})", flush=True)

    mpr_metro = sweeps_per_round * n
    mpr_mala = sweeps_per_round // 2
    traj_hmc = max(1, sweeps_per_round // (n_leap + 1))
    budgets = {
        "metropolis": {"moves_per_round": mpr_metro, "grads_per_round": 0},
        "mala": {"moves_per_round": mpr_mala,
                 "grads_per_round": 2 * mpr_mala},
        "hmc": {"moves_per_round": traj_hmc,
                "grads_per_round": traj_hmc * (n_leap + 1)},
    }
    rows = []

    def finish(name, s0, s_end, e, x, dt):
        burn = rounds // 3
        ess_e = multichain_ess(e[:, burn:])
        ess_x = multichain_ess(x[:, burn:])
        acc = float(int((s_end.accepts - s0.accepts).sum())
                    / max(1, int((s_end.attempts - s0.attempts).sum())))
        grads = budgets[name]["grads_per_round"] * rounds
        row = {"sampler": name, "n": n, "wall_s": round(dt, 2),
               "acceptance": round(acc, 4),
               "energy_ess": round(float(ess_e), 1),
               "energy_ess_per_s": round(float(ess_e) / dt, 1),
               "meanx_ess": round(float(ess_x), 1),
               "meanx_ess_per_s": round(float(ess_x) / dt, 1),
               "grad_evals_per_chain": grads,
               **budgets[name]}
        if grads:
            row["energy_ess_per_Mgrad"] = round(
                float(ess_e) / (grads * chains / 1e6), 1)
        rows.append(row)
        print(row, flush=True)

    s_end, e, x, dt = timed_rounds(
        spec, lambda s: run_moves_auto(spec, beta, s, mpr_metro), state0,
        rounds, device)
    finish("metropolis", state0, s_end, e, x, dt)

    def restart(step):
        return state0.replace(
            max_disp=torch.full_like(state0.max_disp, step),
            prev_attempts=state0.attempts, prev_accepts=state0.accepts)

    mala0 = run_mala_equilibration(spec, beta, restart(0.02),
                                   mala_equilibration, 100)
    s_end, e, x, dt = timed_rounds(
        spec, lambda s: run_mala(spec, beta, s, mpr_mala), mala0, rounds,
        device)
    finish("mala", mala0, s_end, e, x, dt)

    hmc0 = run_hmc_equilibration(spec, beta, restart(0.05),
                                 hmc_equilibration, 50, n_leap)
    s_end, e, x, dt = timed_rounds(
        spec, lambda s: run_hmc(spec, beta, s, traj_hmc, n_leap), hmc0,
        rounds, device)
    finish("hmc", hmc0, s_end, e, x, dt)
    return rows


def build_verdict(rows) -> str:
    """Which sampler leads on energy ESS/s at each N, and whether on mean
    x too (the JAX tool's verdict, its TPU-specific clause left out)."""
    m = {(r["n"], r["sampler"]): r for r in rows}
    ns = sorted({r["n"] for r in rows})

    def f(n, s, k):
        return m[(n, s)][k]

    per_n = []
    for n in ns:
        e = {s: f(n, s, "energy_ess_per_s")
             for s in ("metropolis", "mala", "hmc")}
        x = {s: f(n, s, "meanx_ess_per_s")
             for s in ("metropolis", "mala", "hmc")}
        best_e = max(e, key=e.get)
        both = best_e == max(x, key=x.get)
        per_n.append(
            f"N={n}: energy ESS/s {e['metropolis']:.0f} / {e['mala']:.0f} "
            f"/ {e['hmc']:.0f} (Metropolis/MALA/HMC), mean-x "
            f"{x['metropolis']:.0f} / {x['mala']:.0f} / {x['hmc']:.0f} — "
            f"best {'on both observables' if both else 'on energy only'}: "
            f"{best_e}")
    return ("Verdict: " + "; ".join(per_n) + ".  ESS per Mgrad at "
            f"N={ns[0]}: HMC {f(ns[0], 'hmc', 'energy_ess_per_Mgrad'):.0f},"
            f" MALA {f(ns[0], 'mala', 'energy_ess_per_Mgrad'):.0f}.")


def render_section(data) -> str:
    """SAMPLERS.md's within-well section."""
    sys_desc = " / ".join(f"{c} chains at N={n}"
                          for n, c in data["systems"])
    lines = [SECTION_BEGIN,
             "",
             "## Within-well decorrelation (the gradient samplers' "
             "actual job)",
             "",
             "Single-well system (num_wells=1, V0=-10 — no barrier), "
             f"{sys_desc}, {data['rounds']} rounds; per round Metropolis "
             "runs 50 sweeps (50N single-particle moves), MALA 25 "
             "whole-config moves (50 grad evals), HMC 5 trajectories of "
             "L=10 leapfrog steps (55 grad evals) — MALA and HMC "
             "gradient-matched to ~10%, Metropolis sweep-matched.  Fast "
             "observables (energy/N and mean x), rank-normalized "
             "multichain ESS, burn-in first third.",
             "",
             "| N | sampler | acceptance | energy ESS/s | mean-x ESS/s | "
             "ESS per Mgrad (energy) |",
             "|---|---|---|---|---|---|"]
    for row in data["rows"]:
        lines.append(
            f"| {row['n']} | {row['sampler']} | {row['acceptance']} "
            f"| {row['energy_ess_per_s']} | {row['meanx_ess_per_s']} "
            f"| {row.get('energy_ess_per_Mgrad', '—')} |")
    lines += ["", data["verdict"], "", SECTION_END]
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--systems", default="3:1024,32:256,128:64",
                    help="comma list of N:chains")
    ap.add_argument("--mala_equilibration", type=int, default=1000)
    ap.add_argument("--hmc_equilibration", type=int, default=500)
    add_common_args(ap, "within_well_bench")
    args = ap.parse_args(argv)
    device = tool_device(args.device)

    systems = [tuple(int(v) for v in s.split(":"))
               for s in args.systems.split(",")]
    rows = []
    for n, chains in systems:
        rows += bench_system(n, chains, args.rounds, device=device,
                             seed=args.seed,
                             mala_equilibration=args.mala_equilibration,
                             hmc_equilibration=args.hmc_equilibration)
    data = {"metric": "within_well_bench", "rows": rows,
            "rounds": args.rounds,
            "systems": [list(s) for s in systems],
            "verdict": build_verdict(rows),
            "device": card(device), "seed": args.seed}
    print(render_section(data))
    print(json.dumps(data))
    write_evidence(args.evidence, data)
    return data


if __name__ == "__main__":
    main()
