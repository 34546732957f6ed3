"""Five samplers on the double well, one budget: SAMPLERS.md's table.

Port of ``tools/sampler_bench.py``.  One system (the reference N=3 double
well, barriers of some 10 k_BT), one budget (chains x rounds x moves a
round), five samplers:

  1. plain Metropolis   (one move-kernel launch a round)
  2. MALA               (gradient drifts; proposal energies through the
                         pair-energy kernel)
  3. HMC                (10-step leapfrog trajectories, likewise)
  4. parallel tempering (one move-kernel launch with each chain's beta a
                         round, then the swap)
  5. the flow hybrid    (Algorithm 1's schedule: the local moves, then one
                         flow-proposed move a chain)

For each: wall seconds, acceptance, the slow observable's ESS (the
majority-in-B well label, rank-normalised multichain), ESS/s, the
crossing-rate bound, and the particle-level ΔF against the sector
quadrature.  JAX times one fused scan a sampler; here each sampler's
rounds are a host loop timed by CUDA events (by the host clock on the
CPU), after one untimed warm-up round.

It prints SAMPLERS.md's table, then the within-well section where
``tools.within_well_bench`` has written its evidence
(``within_well_bench --evidence``'s file), and one JSON line with the
JAX tool's keys and the card's name and power limit; it never writes
SAMPLERS.md.

    python -m flowstate_tpu_torch.tools.sampler_bench [--chains 256]
        [--rounds 400] [--samplers plain,mala,hmc,pt,hybrid] [--device cuda]
        [--seed 0] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from flowstate_tpu_torch.analysis.ess import (
    crossing_bound_ess, multichain_ess,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hmc import run_hmc, run_hmc_equilibration
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves
from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
from flowstate_tpu_torch.mcmc.mala import run_mala, run_mala_equilibration
from flowstate_tpu_torch.mcmc.tempering import (
    init_tempered_state, run_replica_exchange, temperature_ladder,
)
from flowstate_tpu_torch.tools.common import (
    EVIDENCE_DIR, HostLoopTimer, add_common_args, card, double_well_spec,
    finite_or_none, tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import (
    equilibrated_state, train_on_configs, well_counts,
)
from flowstate_tpu_torch.tools.exact_free_energy import exact_particle_df
from flowstate_tpu_torch.tools.within_well_bench import render_section

# the within-well section's data, as ``within_well_bench --evidence``
# writes it
WITHIN_WELL = os.path.join(EVIDENCE_DIR, "within_well_bench_torch_data.json")


def _summary(name, obs, counts_ab, dt, acc, burn_frac=1 / 3):
    """obs: (C, T) well-label series; counts_ab: (n_a, n_b) summed over
    the post-burn rounds, or None."""
    t = obs.shape[1]
    burn = int(t * burn_frac)
    ess = multichain_ess(obs[:, burn:])
    crossings = int(np.sum(np.abs(np.diff(obs, axis=1)) > 0.5))
    ess_ub = crossing_bound_ess(obs[:, burn:])
    row = {
        "sampler": name, "wall_s": round(dt, 2),
        "acceptance": round(float(acc), 4),
        "well_ess": round(float(ess), 1),
        "well_ess_per_s": round(float(ess) / dt, 2),
        "crossings": crossings,
        # enough crossings for the autocorrelation, and no more ESS than
        # the crossings support (pinned chains' spread inflates it)
        "ess_reliable": crossings >= 20 and ess <= ess_ub,
        "well_ess_upper_bound": round(float(ess_ub), 1),
        "well_ess_per_s_upper_bound": round(float(ess_ub) / dt, 2),
    }
    if counts_ab is not None:
        n_a, n_b = counts_ab
        row["df_particle"] = round(float(np.log(max(n_b, 1.0)
                                                / max(n_a, 1.0))), 4)
    return row


def run_rounds(spec, move_fn, state, rounds: int, burn: int, device):
    """One untimed warm-up round, then ``rounds`` of ``move_fn`` with the
    well label and counts recorded after each.  Returns (state, (C, T)
    labels, (n_a, n_b) summed over rounds >= burn, seconds)."""
    move_fn(state)
    ws, na, nb = [], [], []
    with HostLoopTimer(device) as timer:
        for _ in range(rounds):
            state = move_fn(state)
            n_a, n_b = well_counts(spec, state.positions)
            ws.append((n_b > n_a).to(torch.float32))
            na.append(n_a)
            nb.append(n_b)
    counts = (float(torch.stack(na[burn:]).sum()),
              float(torch.stack(nb[burn:]).sum()))
    return state, torch.stack(ws, 1).cpu().numpy(), counts, timer.seconds


def acceptance(after, before) -> float:
    return (int((after.accepts - before.accepts).sum())
            / max(1, int((after.attempts - before.attempts).sum())))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--train_cap", type=int, default=102_400)
    ap.add_argument("--samplers", default="plain,mala,hmc,pt,hybrid")
    ap.add_argument("--mala_equilibration", type=int, default=1000)
    ap.add_argument("--hmc_equilibration", type=int, default=500)
    add_common_args(ap, "sampler_bench")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    which = set(args.samplers.split(","))

    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = double_well_spec(3)
    half_box = spec.box.size_x / 2
    state0 = equilibrated_state(spec, c, args.seed, device)
    print(f"equilibrated {c} chains", flush=True)
    rows = []
    burn = rounds // 3

    if "plain" in which:
        s_end, w, counts, dt = run_rounds(
            spec, lambda s: run_moves_auto(spec, 1.0, s, mpr), state0,
            rounds, burn, device)
        rows.append(_summary("plain Metropolis", w, counts, dt,
                             acceptance(s_end, state0)))
        print(rows[-1], flush=True)

    if "mala" in which:
        mala0 = run_mala_equilibration(
            spec, 1.0, state0.replace(
                max_disp=torch.full_like(state0.max_disp, 0.02)),
            args.mala_equilibration, 100)
        s_end, w, counts, dt = run_rounds(
            spec, lambda s: run_mala(spec, 1.0, s, mpr), mala0, rounds, burn,
            device)
        rows.append(_summary("MALA (grad drifts)", w, counts, dt,
                             acceptance(s_end, mala0)))
        print(rows[-1], flush=True)

    if "hmc" in which:
        n_leap = 10
        hmc0 = run_hmc_equilibration(
            spec, 1.0, state0.replace(
                max_disp=torch.full_like(state0.max_disp, 0.05)),
            args.hmc_equilibration, 50, n_leap)
        traj = max(1, mpr // n_leap)
        s_end, w, counts, dt = run_rounds(
            spec, lambda s: run_hmc(spec, 1.0, s, traj, n_leap), hmc0,
            rounds, burn, device)
        rows.append(_summary(f"HMC ({n_leap}-step leapfrog)", w, counts, dt,
                             acceptance(s_end, hmc0)))
        rows[-1]["note"] = (
            f"{traj} trajectories/round x {n_leap + 1} grads = "
            f"{traj * (n_leap + 1)} grad evals/round vs MALA's "
            f"{2 * mpr} (2/move, uncached) — comparable, not "
            "strictly matched")
        print(rows[-1], flush=True)

    r = args.replicas
    if "pt" in which:
        walkers = c // r
        betas = temperature_ladder(1.0, args.t_hot, r, device=device)
        pos_pt, _ = init_alternating_wells(walkers, 3, 0.03)
        st_pt = init_tempered_state(
            spec, torch.as_tensor(np.tile(pos_pt[None], (r, 1, 1, 1)),
                                  device=device), args.seed + 3, 0.65)

        def record(view):
            n_a, n_b = well_counts(spec, view.positions[0])
            return (n_b > n_a).to(torch.float32), n_a, n_b

        def pt(n_rounds):
            g = torch.Generator(device=device).manual_seed(args.seed + 4)
            return run_replica_exchange(spec, betas, st_pt, g, n_rounds, mpr,
                                        record_fn=record)

        pt(1)                                       # warm-up, untimed
        with HostLoopTimer(device) as timer:
            res = pt(rounds)
        w_pt, n_a, n_b = res.extras
        rows.append(_summary(
            f"parallel tempering ({r}x{walkers})", w_pt.T.cpu().numpy(),
            (float(n_a[burn:].sum()), float(n_b[burn:].sum())),
            timer.seconds, float(res.edge_acceptance.mean())))
        rows[-1]["note"] = "acceptance = mean edge-swap rate"
        print(rows[-1], flush=True)

    dt_train = 0.0
    if "hybrid" in which:
        s, configs = state0, []
        for _ in range(rounds):
            s = run_moves_auto(spec, 1.0, s, mpr)
            configs.append(s.positions)
        with HostLoopTimer(device) as timer:
            model, loss_epoch, n_rows = train_on_configs(
                spec, torch.cat(configs), args.train_cap, args.epochs,
                args.seed + 1, device)
        dt_train = timer.seconds
        del configs
        print(f"flow trained on {n_rows} configs: fKLD {loss_epoch[0]:.2f} "
              f"-> {loss_epoch[-1]:.2f} in {dt_train:.1f}s", flush=True)
        g = torch.Generator(device=device).manual_seed(args.seed + 5)

        def hybrid_move(st):
            st = run_moves_auto(spec, 1.0, st, mpr)
            return nf_big_moves(spec, 1.0, st, model, half_box, g).state

        s_end, w, counts, dt = run_rounds(spec, hybrid_move, state0, rounds,
                                          burn, device)
        # the teleport acceptance from one more round (the counters hold
        # the local moves too)
        acc_big = float(nf_big_moves(spec, 1.0, s_end, model, half_box,
                                     g).accepted.float().mean())
        rows.append(_summary("NF-hybrid (A1 schedule)", w, counts, dt,
                             acc_big))
        rows[-1]["note"] = "acceptance = flow-teleport rate"
        rows[-1]["train_wall_s"] = round(dt_train, 1)
        print(rows[-1], flush=True)

    exact_df, exact_df_sem = exact_particle_df(device=device)
    exact_df = round(exact_df, 4)
    by_name = {row["sampler"].split(" ")[0]: row for row in rows}
    speedup_lb = None
    if "plain" in by_name and "NF-hybrid" in by_name:
        plain_ub = by_name["plain"]["well_ess_per_s_upper_bound"]
        hyb = by_name["NF-hybrid"]
        if hyb["ess_reliable"] and plain_ub > 0:
            speedup_lb = round(hyb["well_ess_per_s"] / plain_ub, 1)
    result = {"metric": "sampler_bench", "rows": rows,
              "exact_df_particle": exact_df,
              "exact_df_particle_sem": round(exact_df_sem, 5),
              "hybrid_vs_plain_ess_speedup_lower_bound": speedup_lb,
              "budget": f"{c} chains x {rounds} rounds x {mpr} moves",
              "device": card(device), "seed": args.seed,
              "timing": "host loop of rounds, CUDA events on the card"}

    lines = ["| sampler | wall (s) | acceptance | crossings | well ESS "
             f"| well ESS/s | dF (exact {exact_df}) |",
             "|---|---|---|---|---|---|---|"]
    for row in rows:
        ess_s = (f"**{row['well_ess_per_s']}**" if row["ess_reliable"]
                 else f"<= {row['well_ess_per_s_upper_bound']} "
                      f"(crossing-rate bound; {row['crossings']} crossings)")
        lines.append(f"| {row['sampler']} | {row['wall_s']} "
                     f"| {row['acceptance']} | {row['crossings']} "
                     f"| {row['well_ess']} | {ess_s} "
                     f"| {row.get('df_particle', '—')} |")
    if speedup_lb is not None:
        lines.append(f"\nNF-hybrid ESS/s over the plain crossing-rate "
                     f"bound: >= {speedup_lb}x.")
    print("\n".join(lines))
    if os.path.exists(WITHIN_WELL):
        with open(WITHIN_WELL) as f:
            print(render_section(json.load(f)))
    clean = finite_or_none(result)
    print(json.dumps(clean))
    write_evidence(args.evidence, clean)
    return result


if __name__ == "__main__":
    main()
