"""ESS/s of the slow observable (the well label): the flow hybrid against
plain Metropolis.

Port of ``tools/ess_check.py`` (ESS.md's table).  The slow observable is
each chain's well label: 1 if most of its particles sit in well B.  Plain
Metropolis (one move-kernel launch of ``--moves_per_round`` moves a round)
barely crosses the 10 k_BT barrier, so its label's ESS is about zero; the
hybrid adds one flow-proposed independence move a round
(``mcmc.hybrid.nf_big_moves``, the proposals' energies through the
pair-energy kernel), with the K=15 circular-spline flow trained on the
plain rounds' configurations.  ESS: the rank-normalised split-chain
multichain estimator (``analysis/ess.py::multichain_ess``).

The headline ESS/s is withheld unless the hybrid's particle-level ΔF =
ln(sum n_B / sum n_A) lies within 2 standard errors (its SEM over chains
and the quadrature's own, in quadrature) of the exact value from the
sector quadrature (``tools.exact_free_energy.exact_particle_df``: 4 seeds
of 4e6 points a sector, about 0.3926), as in the JAX tool.

Each round's time is a host loop timed by CUDA events (on the CPU by the
host clock); a warm-up round of each kind runs first, untimed.  It prints
ESS.md's table and one JSON line with the JAX tool's keys and the card's
name and power limit; it never writes ESS.md.

    python -m flowstate_tpu_torch.tools.ess_check [--chains 256]
        [--rounds 400] [--epochs 40] [--device cuda] [--seed 0] [--evidence]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flowstate_tpu_torch.analysis.ess import (
    crossing_bound_ess, effective_sample_size, multichain_ess,
)
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves, to_centered
from flowstate_tpu_torch.mcmc.initialise import init_split_wells
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, double_well_spec, finite_or_none,
    tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.exact_free_energy import exact_particle_df
from flowstate_tpu_torch.training import TrainConfig, train

WELL_RADIUS = 1.1 * 1.2
FLOW_WIDTHS = dict(K=15, hidden_units=256, num_bins=32)    # A1's flow


def well_counts(spec, positions: torch.Tensor):
    """(C, N, 2) -> each chain's particle counts (n_A, n_B) inside the
    classification circles (min-image, radius 1.1 r0)."""
    lx, ly = spec.box.size_x, spec.box.size_y
    sizes = torch.tensor([lx, ly], dtype=positions.dtype,
                         device=positions.device)

    def count_in(center):
        d = positions - torch.tensor(center, dtype=positions.dtype,
                                     device=positions.device)
        d = d - sizes * torch.round(d / sizes)
        return torch.sum(torch.sqrt(torch.sum(d * d, dim=-1))
                         <= WELL_RADIUS, dim=-1)

    return count_in([lx / 4, ly / 2]), count_in([3 * lx / 4, ly / 2])


def well_state(spec, positions: torch.Tensor) -> torch.Tensor:
    """(C, N, 2) -> (C,) float32: 1 where most particles sit in well B."""
    n_a, n_b = well_counts(spec, positions)
    return (n_b > n_a).to(torch.float32)


def particle_df(cnt_a: np.ndarray, cnt_b: np.ndarray):
    """Particle-level ΔF = ln(sum n_B / sum n_A) of (T, C) well counts,
    and its standard error over the chains' own ΔFs."""
    df = float(np.log(cnt_b.sum() / max(cnt_a.sum(), 1.0)))
    chain_df = np.log(np.maximum(cnt_b.sum(axis=0), 1.0)
                      / np.maximum(cnt_a.sum(axis=0), 1.0))
    return df, float(np.std(chain_df, ddof=1) / np.sqrt(len(chain_df)))


def equilibrated_state(spec, chains: int, seed: int, device,
                       steps: int = None):
    """The split-wells start (``init_split_wells``: in-well grids up to
    N = 12, half-box lattices above) at rho 0.03 and displacement 0.65,
    then ``steps`` kernel moves (by default ``common.EQUILIBRATION_MOVES``)
    with the displacement adapted every 500."""
    positions, _ = init_split_wells(chains, spec.num_particles, 0.03)
    state = init_chain_state(spec, torch.as_tensor(positions, device=device),
                             seed, 0.65)
    return run_equilibration(
        spec, 1.0, state, steps or common.EQUILIBRATION_MOVES, 500,
        move_fn=lambda s, m: run_moves_auto(spec, 1.0, s, m))


def train_on_configs(spec, configs: torch.Tensor, train_cap: int,
                     epochs: int, seed: int, device, batch: int = 512):
    """The circular-spline flow (``FLOW_WIDTHS``) trained at lr 1e-4 on
    the configurations (centred, subsampled to ``train_cap`` by a uniform
    stride).  Returns (model, loss per epoch, rows)."""
    half_box = spec.box.size_x / 2
    data = to_centered(configs.reshape(-1, spec.num_particles, 2), half_box)
    if data.shape[0] > train_cap:
        idx = np.linspace(0, data.shape[0] - 1, train_cap, dtype=np.int64)
        data = data[torch.as_tensor(idx, device=data.device)]
    g = torch.Generator(device=device).manual_seed(seed)
    model = build_circular_flow(spec.num_particles, 2, half_box,
                                num_blocks=2, generator=g, device=device,
                                **FLOW_WIDTHS)
    config = TrainConfig(batch_size=min(batch, int(data.shape[0])),
                         epochs=epochs, lr=1e-4)
    _, _, _, loss_epoch = train(model, data, config, g)
    return model, loss_epoch, int(data.shape[0])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=256)
    parser.add_argument("--rounds", type=int, default=400)
    parser.add_argument("--moves_per_round", type=int, default=150)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--train_cap", type=int, default=102_400,
                        help="training configurations at most (the "
                             "reference Algorithm 1's budget)")
    parser.add_argument("--exact_samples", type=int, default=4_000_000,
                        help="quadrature points a sector a seed")
    parser.add_argument("--exact_seeds", type=int, default=4)
    add_common_args(parser, "ess_check")
    args = parser.parse_args(argv)
    device = tool_device(args.device)

    c, mpr = args.chains, args.moves_per_round
    spec = double_well_spec(3)
    half_box = spec.box.size_x / 2
    state0 = equilibrated_state(spec, c, args.seed, device)
    print(f"equilibrated {c} chains", flush=True)

    # (a) plain Metropolis: rounds of local moves, the well label recorded
    def plain_round(s):
        s = run_moves_auto(spec, 1.0, s, mpr)
        return s, well_state(spec, s.positions)

    plain_round(state0)                           # warm-up, untimed
    state, obs, configs = state0, [], []
    with HostLoopTimer(device) as timer:
        for _ in range(args.rounds):
            state, w = plain_round(state)
            obs.append(w)
            configs.append(state.positions)
    dt_plain = timer.seconds
    obs_plain = torch.stack(obs, dim=1).cpu().numpy()      # (C, T)
    ess_plain = multichain_ess(obs_plain)
    crossings = int(np.sum(np.abs(np.diff(obs_plain, axis=1)) > 0.5))
    ess_plain_ub = crossing_bound_ess(obs_plain)
    print(f"plain: {dt_plain:.1f}s, {crossings} crossings, ESS "
          f"{ess_plain:.2f} (crossing-rate bound {ess_plain_ub:.1f})",
          flush=True)

    # the flow, trained on the plain rounds' configurations
    with HostLoopTimer(device) as timer:
        model, loss_epoch, rows = train_on_configs(
            spec, torch.cat(configs), args.train_cap, args.epochs,
            args.seed + 1, device)
    dt_train = timer.seconds
    del configs
    print(f"trained on {rows} configs: fKLD {loss_epoch[0]:.2f} -> "
          f"{loss_epoch[-1]:.2f} in {dt_train:.1f}s", flush=True)

    # (b) the hybrid: the same local moves and one flow move a round
    g = torch.Generator(device=device).manual_seed(args.seed + 3)

    def hybrid_round(s):
        s = run_moves_auto(spec, 1.0, s, mpr)
        res = nf_big_moves(spec, 1.0, s, model, half_box, g)
        n_a, n_b = well_counts(spec, res.state.positions)
        return res.state, (n_b > n_a).to(torch.float32), res.accepted, n_a, n_b

    hybrid_round(state0)                          # warm-up, untimed
    state, obs, acc, cnt_a, cnt_b = state0, [], [], [], []
    with HostLoopTimer(device) as timer:
        for _ in range(args.rounds):
            state, w, a, n_a, n_b = hybrid_round(state)
            obs.append(w)
            acc.append(a)
            cnt_a.append(n_a)
            cnt_b.append(n_b)
    dt_h = timer.seconds
    obs_h = torch.stack(obs, dim=1).cpu().numpy()
    acceptance = float(torch.stack(acc).float().mean())
    burn = args.rounds // 3
    ess_h = multichain_ess(obs_h[:, burn:])
    ess_h_geyer = effective_sample_size(obs_h[:, burn:])
    cnt_a_arr = torch.stack(cnt_a).double().cpu().numpy()   # (T, C)
    cnt_b_arr = torch.stack(cnt_b).double().cpu().numpy()
    df, df_sem = particle_df(cnt_a_arr[burn:], cnt_b_arr[burn:])
    # the same estimate after a burn of 2/3 of the rounds: a start that is
    # not yet forgotten moves it
    df_late, df_late_sem = particle_df(cnt_a_arr[2 * args.rounds // 3:],
                                       cnt_b_arr[2 * args.rounds // 3:])
    exact_df, exact_sem = exact_particle_df(args.exact_samples,
                                            args.exact_seeds, device)
    exact_df = round(exact_df, 4)
    gate_tol = 2.0 * float(np.hypot(df_sem, exact_sem))
    df_ok = abs(df - exact_df) <= gate_tol
    print(f"hybrid: {dt_h:.1f}s, acceptance {acceptance:.3f}, ESS "
          f"{ess_h:.1f} (per-chain Geyer sum {ess_h_geyer:.1f}), dF "
          f"{df:.3f} +- {df_sem:.3f} ({'OK' if df_ok else 'FAILS 2-sigma'}"
          f" vs {exact_df} +- {exact_sem:.4f})", flush=True)

    ess_per_s_h = ess_h / dt_h
    ess_per_s_p = ess_plain / dt_plain
    ess_per_s_p_ub = ess_plain_ub / dt_plain
    plain_reliable = crossings >= 20 and ess_plain <= ess_plain_ub
    speedup = (round(ess_per_s_h / ess_per_s_p, 1)
               if plain_reliable and ess_per_s_p > 0 else None)
    speedup_lb = (round(ess_per_s_h / ess_per_s_p_ub, 1)
                  if ess_per_s_p_ub > 0 else None)
    result = {
        "metric": "well_state_ess_per_s",
        "value": round(ess_per_s_h, 3) if df_ok else None,
        "unit": "ESS/s",
        "gated": None if df_ok else (
            f"|dF - exact| = {abs(df - exact_df):.3f} > 2*sigma "
            f"= {gate_tol:.3f}; headline withheld"),
        "estimator": "rank-normalized split-chain multichain ESS",
        "hybrid_ess": round(ess_h, 1),
        "hybrid_ess_geyer_sum": round(ess_h_geyer, 1),
        "plain_ess_per_s": round(ess_per_s_p, 6),
        "plain_ess_per_s_upper_bound": round(ess_per_s_p_ub, 4),
        "plain_crossings": crossings,
        "hybrid_acceptance": round(acceptance, 4),
        "hybrid_delta_f": round(df, 4),
        "hybrid_delta_f_sem": round(df_sem, 4),
        "hybrid_delta_f_burn_two_thirds": round(df_late, 4),
        "hybrid_delta_f_burn_two_thirds_sem": round(df_late_sem, 4),
        "exact_delta_f": exact_df,
        "exact_delta_f_sem": round(exact_sem, 5),
        "ess_speedup_vs_plain": speedup,
        "ess_speedup_vs_plain_lower_bound": speedup_lb,
        "burn_rounds": burn,
        "chains": c,
        "rounds": args.rounds,
        "device": card(device),
        "plain_wall_s": dt_plain, "hybrid_wall_s": dt_h,
        "train_wall_s": dt_train, "train_rows": rows,
        "epochs": args.epochs, "final_loss": loss_epoch[-1],
        "flow": dict(FLOW_WIDTHS),
        "df_gate_tol": gate_tol,
    }
    plain_ess = (f"{ess_per_s_p:.4f}" if plain_reliable else
                 f"<= {ess_per_s_p_ub:.4f} (crossing-rate bound)")
    print("| quantity | plain Metropolis | NF-hybrid |\n|---|---|---|\n"
          f"| wall time | {dt_plain:.1f} s | {dt_h:.1f} s |\n"
          f"| well-state ESS | {ess_plain:.2f} | {ess_h:.1f} (per-chain "
          f"Geyer sum: {ess_h_geyer:.1f}) |\n"
          f"| well-state ESS/s | {plain_ess} | {ess_per_s_h:.2f} |\n"
          f"| well crossings observed | {crossings} | — (teleports, "
          f"acceptance {acceptance:.3f}) |\n"
          f"| ΔF = ln(P_B/P_A), per-particle occupancy | — | {df:.3f} ± "
          f"{df_sem:.3f} (exact {exact_df} ± {exact_sem:.4f}; burn 2/3: "
          f"{df_late:.3f} ± {df_late_sem:.3f}) |\n\n"
          f"ΔF gate: |ΔF − {exact_df}| = {abs(df - exact_df):.3f} vs 2·σ = "
          f"{gate_tol:.3f} → {'PASS' if df_ok else 'FAIL'}.")
    clean = finite_or_none(result)
    print(json.dumps(clean))
    write_evidence(args.evidence, clean)
    return result


if __name__ == "__main__":
    main()
