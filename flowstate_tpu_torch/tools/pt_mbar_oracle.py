"""Particle-level ΔF by parallel tempering with the whole ladder pooled by
MBAR.

Port of ``tools/pt_mbar_oracle.py``: at each N, a replica-exchange run
(``--replicas`` x ``--walkers``, geometric T from 1 to ``--t_hot``; one
move-kernel launch with each chain's beta a round, then the swap) from
the split-wells start equilibrated at every rung, every replica recorded;
after a burn of a third of the rounds every sample is reweighted to the
cold state by MBAR (``analysis/mbar.py``, float64 on the device) and
ΔF = ln(E[n_B] / E[n_A]) taken there, with the spread of 5 round blocks
(sharing the free energies) as its error; beside it the cold replica's
own estimate.

It prints one line a system and one JSON line with the JAX tool's
``metric`` and ``df`` and each system's result under its keys, with the
card's name and power limit.  It writes only ``--evidence``, never the
JAX tool's ``results/evidence/hybrid_n_scaling.json``.

    python -m flowstate_tpu_torch.tools.pt_mbar_oracle [--n_list 8,16,32]
        [--pt_rounds 600] [--device cuda] [--seed 0] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from flowstate_tpu_torch.analysis.mbar import (
    mbar_free_energies, mbar_log_weights,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.initialise import init_split_wells
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.tempering import (
    chain_betas, init_tempered_state, run_replica_exchange,
    temperature_ladder,
)
from flowstate_tpu_torch.tools.common import (
    add_common_args, card, double_well_spec, sync, tool_device,
    write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import well_counts


def weighted_particle_df(log_w: np.ndarray, n_a: np.ndarray,
                         n_b: np.ndarray) -> float:
    """ln(E[n_B] / E[n_A]) under the normalised weights exp(log_w)."""
    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    return float(np.log(max((w * n_b).sum(), 1e-300)
                        / max((w * n_a).sum(), 1e-300)))


def run_for_n(n: int, args, device) -> dict:
    spec = double_well_spec(n)
    r, walkers = args.replicas, args.walkers
    betas = temperature_ladder(1.0, args.t_hot, r, device=device)
    pos, _ = init_split_wells(walkers, n, 0.03)
    st = init_tempered_state(
        spec, torch.as_tensor(np.broadcast_to(pos, (r, walkers, n, 2)).copy(),
                              device=device), args.seed + 300 + n, 0.65)
    beta_c = chain_betas(betas, walkers)
    st = run_equilibration(spec, beta_c, st, 2000, 500,
                           move_fn=lambda s, m: run_moves_auto(spec, beta_c,
                                                               s, m))
    g = torch.Generator(device=device).manual_seed(args.seed + 400 + n)
    sync(device)
    t0 = time.perf_counter()
    res = run_replica_exchange(spec, betas, st, g, args.pt_rounds,
                               args.moves_per_round, record="all")
    sync(device)
    pt_s = time.perf_counter() - t0

    burn = args.pt_rounds // 3
    pos = res.cold_positions[burn:]                  # (T, R, W, N, 2)
    energies = res.cold_energy[burn:]                # (T, R, W)
    t = pos.shape[0]
    n_a, n_b = well_counts(spec, pos.reshape(-1, n, 2))
    n_a = n_a.reshape(t, r, walkers).cpu().numpy()
    n_b = n_b.reshape(t, r, walkers).cpu().numpy()
    df_cold = float(np.log(max(n_b[:, 0].sum(), 1.0)
                           / max(n_a[:, 0].sum(), 1.0)))

    # MBAR over the pooled ladder in float64: u_kn = beta_k E_n
    e_n = energies.permute(1, 0, 2).reshape(r, -1).double()   # (R, T W)
    m = e_n.shape[1]
    u_kn = betas.double()[:, None] * e_n.reshape(-1)[None, :]
    n_k = torch.full((r,), m, dtype=torch.float64, device=device)
    f_k = mbar_free_energies(u_kn, n_k, num_iters=args.mbar_iters)
    log_w = mbar_log_weights(u_kn, n_k, f_k, 0).cpu().numpy()
    na_pool = n_a.transpose(1, 0, 2).reshape(-1)
    nb_pool = n_b.transpose(1, 0, 2).reshape(-1)
    df_mbar = weighted_particle_df(log_w, na_pool, nb_pool)

    # the error: 5 round blocks, the free energies shared
    blocks = []
    w_idx = np.arange(r * m).reshape(r, t, walkers)
    for b in range(5):
        sel = np.zeros(r * m, bool)
        sel[w_idx[:, b * t // 5:(b + 1) * t // 5].reshape(-1)] = True
        blocks.append(weighted_particle_df(
            np.where(sel, log_w, -np.inf), na_pool, nb_pool))
    sem = float(np.std(blocks) / np.sqrt(len(blocks)))
    out = {"df_particle_mbar": round(df_mbar, 4),
           "df_particle_mbar_sem": round(sem, 4),
           "df_particle_cold_only": round(df_cold, 4),
           "pooled_samples": int(r * m),
           "f_k": [round(float(x), 3) for x in f_k.cpu()],
           "ladder": f"{r}x{walkers}, T_hot={args.t_hot}",
           "pt_rounds": args.pt_rounds,
           "edge_acceptance": [round(float(a), 4)
                               for a in res.edge_acceptance.cpu()],
           "pt_wall_s": pt_s}
    print(f"N={n}: MBAR dF={df_mbar:.4f} +- {sem:.4f} (cold-only "
          f"{df_cold:.4f}, {r * m} pooled samples, PT {pt_s:.1f} s)",
          flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--walkers", type=int, default=51)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--mbar_iters", type=int, default=500)
    add_common_args(ap, "pt_mbar_oracle")
    args = ap.parse_args(argv)
    device = tool_device(args.device)

    t0 = time.perf_counter()
    systems = {int(x): run_for_n(int(x), args, device)
               for x in args.n_list.split(",")}
    result = {"metric": "pt_mbar_oracle",
              "df": {k: v["df_particle_mbar"] for k, v in systems.items()},
              "systems": systems, "card": card(device), "seed": args.seed,
              "wall_s": time.perf_counter() - t0}
    print(json.dumps(result))
    write_evidence(args.evidence, result)
    return result


if __name__ == "__main__":
    main()
