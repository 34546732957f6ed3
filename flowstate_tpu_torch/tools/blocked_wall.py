"""Past the N-wall: blocked conditional-flow proposals.

Port of ``tools/blocked_wall.py``.  The global independence proposal's
acceptance falls a decade every ~2.3 particles (ln acc = -1.006 N + 1.04,
``n_mitigation``).  This tool measures the structural fix: resample k
particles from a flow conditioned on the other N-k (``mcmc/blocked.py``),
whose acceptance the decay law predicts at ~ e * 10^(-k/2.3) whatever N.

Per particle count N:
  1. the split-wells start, equilibrated (20,000 move-kernel moves);
  2. the PT oracle (``hybrid_n_scaling.pt_oracle``): its particle-level
     ΔF and its cold replica's configurations, the sector-complete
     training set;
  3. per block size k < N: the conditional flow (K=10, hidden 128, 16
     bins, Fourier or coordinate context) trained on the PT data by
     ``train_blocked``; (a) the blocked-move acceptance over
     ``--acc_rounds`` rounds from the equilibrated start, (b) the hybrid
     (one move-kernel launch and ``max(1, N // k)`` blocked moves a
     round): crossings, the well label's ESS with the suppression rule,
     and the particle-level ΔF against PT's (``common.hybrid_summary``).

Every proposal's energy goes through the pair-energy kernel; host loops
are timed by CUDA events after one untimed round.  The result has the JAX
tool's keys; ``--evidence`` is written after each N.  It never writes the
JAX tool's JSON.

    python -m flowstate_tpu_torch.tools.blocked_wall [--n_list 8,16,32]
        [--k_list 1,2,3,4] [--device cuda] [--seed 0] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flowstate_tpu_torch.flows import build_conditional_circular_flow
from flowstate_tpu_torch.mcmc.blocked import (
    block_context, blocked_big_moves, context_dim, fourier_context,
    fourier_context_dim,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, double_well_spec, hybrid_summary,
    particle_df_after, tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import equilibrated_state
from flowstate_tpu_torch.tools.hybrid_n_scaling import pt_oracle, run_hybrid
from flowstate_tpu_torch.training import TrainConfig
from flowstate_tpu_torch.training.blocked import train_blocked


def make_context(args, n: int, k: int, half_box: float):
    """(context_fn, its width): the Fourier modes up to ``args.m_max`` or
    the conditioning particles' coordinates."""
    if args.context == "fourier":
        fn = lambda r, p: fourier_context(r, p, half_box,  # noqa: E731
                                          m_max=args.m_max)
        return fn, fourier_context_dim(args.m_max)
    fn = lambda r, p: block_context(r, p, half_box)        # noqa: E731
    return fn, context_dim(n, k)


def blocked_study(spec, args, state0, data_pt, k: int, half_box: float,
                  ctx_fn, ctx_dim: int, K: int, hidden: int, batch: int,
                  device):
    """A conditional flow trained on ``data_pt`` (the JAX keys 1 and 2 as
    seeds), its acceptance over ``args.acc_rounds`` blocked moves from
    ``state0``, and the hybrid run of ``max(1, N // k)`` blocked moves a
    round.  Returns (loss per epoch, training s, acceptance, hybrid
    fields, blocked moves a round, model)."""
    n = spec.num_particles
    model = build_conditional_circular_flow(
        k, 2, half_box, context_features=ctx_dim, K=K, hidden_units=hidden,
        num_bins=args.bins, num_blocks=2, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    tcfg = TrainConfig(batch_size=batch, epochs=args.epochs, lr=args.lr)
    with HostLoopTimer(device) as timer:
        _, _, loss_epoch = train_blocked(
            model, data_pt, k, half_box, tcfg,
            torch.Generator(device=device).manual_seed(args.seed + 2),
            context_fn=ctx_fn)

    # acceptance over fresh proposals on the equilibrated ensemble
    g = torch.Generator(device=device).manual_seed(args.seed + 3)
    st, acc = state0, []
    for _ in range(args.acc_rounds):
        r1 = blocked_big_moves(spec, 1.0, st, model, half_box, k, g,
                               context_fn=ctx_fn)
        st = r1.state
        acc.append(r1.accepted.float().mean())
    acc = float(torch.stack(acc).mean())

    # hybrid production: {mpr local + one blocked sweep}/round
    bpr = max(1, n // k)
    g = torch.Generator(device=device).manual_seed(args.seed + 4)

    def hybrid_move(s):
        s = run_moves_auto(spec, 1.0, s, args.moves_per_round)
        for _ in range(bpr):
            s = blocked_big_moves(spec, 1.0, s, model, half_box, k, g,
                                  context_fn=ctx_fn).state
        return s

    (w, n_a, n_b), dt = run_hybrid(spec, state0, args.rounds, device,
                                   hybrid_move)
    return loss_epoch, timer.seconds, acc, (w, n_a, n_b, dt), bpr, model


def pt_data(spec, args, device):
    """The PT oracle's ΔF, its seconds and its cold configurations after
    the burn, (S, N, 2) in the box frame."""
    _, dt_pt, burn, (na_pt, nb_pt, cold_pos) = pt_oracle(
        spec, args, args.seed, device)
    df_pt = particle_df_after(na_pt.T, nb_pt.T, burn)
    data = cold_pos[burn:].reshape(-1, spec.num_particles, 2)
    return df_pt, dt_pt, data


def run_for_n(n: int, args, device) -> dict:
    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = double_well_spec(n, r0=args.r0)
    half_box = spec.box.size_x / 2
    out = {"n": n, "chains": c, "rounds": rounds, "moves_per_round": mpr,
           "box_l": 2 * half_box}

    state0 = equilibrated_state(spec, c, args.seed + n, device,
                                common.SPLIT_EQUILIBRATION_MOVES)
    print(f"N={n}: equilibrated {c} chains "
          f"(E/N={float(state0.energy.mean()) / n:.2f})", flush=True)

    # ---- PT oracle + sector-complete training data ---------------------
    df_pt, dt_pt, data_pt = pt_data(spec, args, device)
    out["pt"] = {"df_particle": round(df_pt, 4), "wall_s": round(dt_pt, 2),
                 "ladder": f"{args.replicas}x{c // args.replicas}, "
                           f"T_hot={args.t_hot}"}
    print(f"N={n}: PT dF={df_pt:.4f} ({dt_pt:.1f}s)", flush=True)
    out["train_configs"] = int(data_pt.shape[0])

    # ---- blocked flow per k -------------------------------------------
    out["blocks"] = []
    for k in [int(x) for x in args.k_list.split(",") if int(x) < n]:
        ctx_fn, ctx_dim = make_context(args, n, k, half_box)
        loss_epoch, dt_train, acc, (w, n_a, n_b, dt), bpr, _ = blocked_study(
            spec, args, state0, data_pt, k, half_box, ctx_fn, ctx_dim,
            args.K, args.hidden, 512, device)
        row = {"k": k, "context": args.context,
               "train_wall_s": round(dt_train, 1),
               "loss_first": round(float(loss_epoch[0]), 3),
               "loss_last": round(float(loss_epoch[-1]), 3),
               "predicted_acceptance": round(
                   float(np.e * 10 ** (-k / 2.3)), 5),
               "acceptance": round(acc, 5)}
        row.update(hybrid_summary(w, n_a, n_b, dt, df_pt),
                   blocked_per_round=bpr)
        print(f"N={n} k={k}: acc={acc:.4f} (predicted "
              f"{row['predicted_acceptance']:.4f}) "
              f"dF={row['df_particle']:.4f} (PT {df_pt:.4f}) "
              f"crossings={row['crossings']}", flush=True)
        out["blocks"].append(row)
    return out


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--k_list", default="1,2,3,4")
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--context", choices=("fourier", "coords"),
                    default="fourier")
    ap.add_argument("--m_max", type=int, default=3)
    ap.add_argument("--r0", type=float, default=1.2,
                    help="well radius: 1.2 = reference; larger separates "
                         "crowding from particle count (deep-well regime "
                         "at higher N)")
    add_common_args(ap, "blocked_wall")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = tool_device(args.device)
    results = {"metric": "blocked_wall", "device": card(device),
               "flow": f"K={args.K} hidden={args.hidden} bins={args.bins} "
                       f"context={args.context}(m_max={args.m_max})",
               "decay_law": "r4 global-proposal fit: ln(acc) = -1.006 N "
                            "+ 1.04; blocked prediction acc ~ e*10^(-k/2.3)"
                            " independent of N",
               "seed": args.seed, "systems": []}
    for n in [int(x) for x in args.n_list.split(",")]:
        results["systems"].append(run_for_n(n, args, device))
        write_evidence(args.evidence, results)
    print(json.dumps({"metric": "blocked_wall",
                      "n_done": [s["n"] for s in results["systems"]]}))
    return results


if __name__ == "__main__":
    main()
