"""The hybrid beyond N=3: flow training, big-move acceptance and ΔF
against parallel tempering at N = 8, 16, 32.

Port of ``tools/hybrid_n_scaling.py``.  Per particle count N:

1. chains split between the wells (``init_split_wells``: in-well grids
   up to N = 12, half-box lattices above), 20,000 move-kernel moves with
   the displacement adapted every 500;
2. local training data: ``--collect_rounds`` rounds of one move-kernel
   launch of ``--moves_per_round`` moves (Algorithm 1's recipe);
3. parallel tempering, the flow-free oracle: ``--replicas`` x
   ``chains // replicas`` walkers, T from 1 to ``--t_hot``, one kernel
   launch with each chain's beta a round; the cold replica's well label,
   well counts and configurations recorded each round, its
   particle-level ΔF after a burn of a third, and its configurations as
   a second training set;
4. for each training set (local, PT): the circular-spline flow (2N
   features) trained at lr 1e-4, batch 512; its big-move acceptance over
   ``--acc_rounds`` fresh proposals from the equilibrated start; then the
   hybrid (one kernel launch and one flow move a round) for the well
   label's ESS and the particle-level ΔF against PT's
   (``common.hybrid_summary``).

Every proposal's energy goes through the pair-energy kernel.  The PT run
and the hybrid are host loops timed by CUDA events after one untimed
round (``common.timed``).  The result has the JAX tool's keys, the card's
name and power limit under ``device``; ``--evidence`` is written after
each N.  It never writes the JAX tool's JSON or RESULTS.md.

    python -m flowstate_tpu_torch.tools.hybrid_n_scaling [--n_list 8,16,32]
        [--device cuda] [--seed 0] [--evidence [PATH]]
    python -m flowstate_tpu_torch.tools.hybrid_n_scaling --resuppress \\
        --evidence PATH
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flowstate_tpu_torch.analysis.ess import multichain_ess
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves, to_centered
from flowstate_tpu_torch.mcmc.initialise import init_split_wells
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.tempering import (
    chain_betas, init_tempered_state, run_replica_exchange,
    temperature_ladder,
)
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, double_well_spec, ess_fields,
    hybrid_summary, particle_df_after, timed,
    tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import (
    equilibrated_state, well_counts, well_state,
)
from flowstate_tpu_torch.training import TrainConfig, train


def resuppress(path: str) -> None:
    """Apply the suppression rule to an existing evidence JSON in place."""
    with open(path) as f:
        doc = json.load(f)
    for sys_row in doc.get("systems", []):
        for key in ("local_trained", "pt_trained"):
            var = sys_row.get(key)
            if not var or var.get("ess_reliable", True):
                continue
            ess = var.get("well_ess_suppressed_estimate")
            if ess is None:
                ess = var.get("well_ess")
            dt = var.get("wall_s", 1.0)
            var.update(ess_fields(float(ess), float(
                var["well_ess_upper_bound"]), float(dt), False))
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"resuppressed unreliable ESS fields in {path}")


def pt_oracle(spec, args, seed: int, device, labels: bool = False):
    """The PT oracle of the N-scaling studies: the split-wells start at
    every rung (2000 moves adapted every 500), ``args.pt_rounds`` rounds
    timed after one untimed round, the cold replica recorded.  Returns
    (result, seconds, burn, records): ``records`` holds the cold
    replica's (T, W) counts n_A, n_B, its (T, W, N, 2) configurations and,
    with ``labels``, first its (T, W) well labels."""
    n = spec.num_particles
    r = args.replicas
    walkers = args.chains // r
    betas = temperature_ladder(1.0, args.t_hot, r, device=device)
    pos, _ = init_split_wells(walkers, n, 0.03)
    st = init_tempered_state(
        spec, torch.as_tensor(np.broadcast_to(pos, (r, walkers, n, 2)).copy(),
                              device=device), seed + 100 + n, 0.65)
    beta_c = chain_betas(betas, walkers)
    st = run_equilibration(spec, beta_c, st, 2000, 500,
                           move_fn=lambda s, m: run_moves_auto(spec, beta_c,
                                                               s, m))

    def record(view):
        cold = view.positions[0]
        n_a, n_b = well_counts(spec, cold)
        out = (n_a, n_b, cold)
        return (well_state(spec, cold),) + out if labels else out

    def run(rounds, gen_seed):
        g = torch.Generator(device=device).manual_seed(gen_seed)
        return run_replica_exchange(spec, betas, st, g, rounds,
                                    args.moves_per_round, record="cold",
                                    record_fn=record)

    res, dt = timed(lambda: run(args.pt_rounds, seed + 200 + n), device,
                    warmup=lambda: run(1, seed + 250 + n))
    return res, dt, args.pt_rounds // 3, res.extras


def run_hybrid(spec, state0, rounds: int, device, move):
    """``rounds`` rounds of ``move(state)`` from ``state0``, timed after
    one untimed round; returns ((C, T) well labels, n_A, n_B), seconds."""
    def loop():
        st, w, n_a, n_b = state0, [], [], []
        for _ in range(rounds):
            st = move(st)
            a, b = well_counts(spec, st.positions)
            w.append((b > a).to(torch.float32))
            n_a.append(a)
            n_b.append(b)
        return tuple(torch.stack(x, dim=1).cpu().numpy()
                     for x in (w, n_a, n_b))

    return timed(loop, device, warmup=lambda: move(state0))


def run_for_n(n: int, args, device) -> dict:
    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = double_well_spec(n)
    beta = 1.0
    half_box = spec.box.size_x / 2
    out = {"n": n, "chains": c, "rounds": rounds, "moves_per_round": mpr,
           "box_l": 2 * half_box}

    state0 = equilibrated_state(spec, c, args.seed + n, device,
                                common.SPLIT_EQUILIBRATION_MOVES)
    print(f"N={n}: equilibrated {c} chains "
          f"(E/N={float(state0.energy.mean()) / n:.2f})", flush=True)

    # ---- 2) local training data (A1 recipe) ----------------------------
    st, configs = state0, []
    for _ in range(args.collect_rounds):
        st = run_moves_auto(spec, beta, st, mpr)
        configs.append(st.positions)
    data_local = to_centered(torch.stack(configs).reshape(-1, n, 2),
                             half_box)
    del configs
    print(f"N={n}: collected {data_local.shape[0]} local configs",
          flush=True)

    # ---- 3) parallel tempering oracle + data ---------------------------
    res, dt_pt, burn_pt, (w_pt, na_pt, nb_pt, cold_pos) = pt_oracle(
        spec, args, args.seed, device, labels=True)
    w_pt = w_pt.cpu().numpy().T
    ess_pt = multichain_ess(w_pt[:, burn_pt:])
    cross_pt = int(np.sum(np.abs(np.diff(w_pt, axis=1)) > 0.5))
    df_pt = particle_df_after(na_pt.T, nb_pt.T, burn_pt)
    out["pt"] = {"df_particle": round(df_pt, 4), "wall_s": round(dt_pt, 2),
                 "crossings": cross_pt,
                 "well_ess": round(float(ess_pt), 1),
                 "well_ess_per_s": round(float(ess_pt) / dt_pt, 2),
                 "edge_acceptance": [round(float(a), 3)
                                     for a in res.edge_acceptance.cpu()],
                 "ladder": f"{args.replicas}x{c // args.replicas}, "
                           f"T_hot={args.t_hot}"}
    print(f"N={n}: PT dF={df_pt:.4f} ({cross_pt} crossings, "
          f"{dt_pt:.1f}s)", flush=True)
    data_pt = to_centered(cold_pos[burn_pt:].reshape(-1, n, 2), half_box)

    # ---- 4) flows + hybrid for each training set -----------------------
    def cap(data):
        if data.shape[0] > args.train_cap:
            idx = np.linspace(0, data.shape[0] - 1, args.train_cap,
                              dtype=np.int64)
            data = data[torch.as_tensor(idx, device=data.device)]
        return data

    def hybrid_variant(tag, data):
        # every variant starts from the same weights, as JAX's key(1)
        model = build_circular_flow(
            n, 2, half_box, K=args.K, hidden_units=args.hidden,
            num_bins=args.bins, num_blocks=2, device=device,
            generator=torch.Generator(device=device).manual_seed(
                args.seed + 1))
        tcfg = TrainConfig(batch_size=512, epochs=args.epochs, lr=1e-4)
        with HostLoopTimer(device) as timer:
            _, _, _, loss_epoch = train(
                model, cap(data), tcfg,
                torch.Generator(device=device).manual_seed(args.seed + 2))
        var = {"train_configs": int(min(data.shape[0], args.train_cap)),
               "train_wall_s": round(timer.seconds, 1),
               "fkld_first": round(float(loss_epoch[0]), 3),
               "fkld_last": round(float(loss_epoch[-1]), 3)}

        # big-move acceptance, measured over acc_rounds fresh proposals
        g = torch.Generator(device=device).manual_seed(args.seed + 3)
        st, acc = state0, []
        for _ in range(args.acc_rounds):
            r1 = nf_big_moves(spec, beta, st, model, half_box, g)
            st = r1.state
            acc.append(r1.accepted.float().mean())
        acc_big = float(torch.stack(acc).mean())
        var["big_move_acceptance"] = round(acc_big, 5)

        # hybrid production: {mpr local + 1 big}/round
        g = torch.Generator(device=device).manual_seed(args.seed + 4)

        def hybrid_move(s):
            s = run_moves_auto(spec, beta, s, mpr)
            return nf_big_moves(spec, beta, s, model, half_box, g).state

        (w, n_a, n_b), dt = run_hybrid(spec, state0, rounds, device,
                                       hybrid_move)
        var.update(hybrid_summary(w, n_a, n_b, dt, df_pt))
        ess = var.get("well_ess_suppressed_estimate", var["well_ess"])
        print(f"N={n} [{tag}]: acc={acc_big:.4f} "
              f"dF={var['df_particle']:.4f} (PT {df_pt:.4f}) "
              f"crossings={var['crossings']} ESS/s={ess / dt:.1f}",
              flush=True)
        return var

    out["local_trained"] = hybrid_variant("local", data_local)
    out["pt_trained"] = hybrid_variant("pt", data_pt)
    return out


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--chains", type=int, default=510,
                    help="divisible by --replicas keeps PT walkers even")
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--collect_rounds", type=int, default=100)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--train_cap", type=int, default=102_400)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--K", type=int, default=15)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--bins", type=int, default=32)
    ap.add_argument("--resuppress", action="store_true",
                    help="only re-apply the unreliable-ESS suppression "
                         "rule to the JSON at --evidence (no run)")
    add_common_args(ap, "hybrid_n_scaling")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.resuppress:
        if not args.evidence:
            raise SystemExit("--resuppress needs --evidence PATH")
        resuppress(args.evidence)
        return None
    device = tool_device(args.device)

    results = {"metric": "hybrid_n_scaling", "device": card(device),
               "flow": f"K={args.K} hidden={args.hidden} bins={args.bins}",
               "seed": args.seed, "systems": []}
    for n in [int(x) for x in args.n_list.split(",")]:
        results["systems"].append(run_for_n(n, args, device))
        # after every N (each takes many minutes)
        write_evidence(args.evidence, results)
    print(json.dumps({"metric": "hybrid_n_scaling",
                      "n_done": [s["n"] for s in results["systems"]]}))
    return results


if __name__ == "__main__":
    main()
