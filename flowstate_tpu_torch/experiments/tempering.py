"""Parallel-tempering production driver.

Port of ``flowstate_tpu/experiments/tempering.py``: per-walker well
statistics and ΔF with its SEM band on the cold replica, the figures'
``*_data.json``, an MBAR ΔF that pools every replica
(``analysis/mbar.py``), edge-acceptance diagnostics, checkpoints and
resume.  The sampler the JAX package recommends for N >= 8.

The tempered state holds R x W chains, replica-major
(``mcmc/tempering.py``).  Equilibration runs every replica at its own beta,
one move-kernel launch per adjustment block; production runs in segments
of ``pt_segment_rounds`` exchange rounds, each round one launch of the
move kernel over all R x W chains and one swap sweep.  A segment's records
(cold-replica positions, every replica's well counts and energies) stay on
the card until it ends; then they land in ``segments/seg_XXXX.npz`` (the
JAX keys and dtypes), the tracked energies are held against the
pair-energy kernel's recompute (the drift is logged, the state is not
changed) and the state is checkpointed.  Each segment's swap generator
comes from ``(master_seed + 1, segment)`` and the chains' Philox counter
is in the checkpoint, so a resumed run draws what an uninterrupted one
would.

    python -m flowstate_tpu_torch.experiments.tempering --experiment_id X \\
        --num_chains 256 --replicas 10 --moves_per_round 50 \\
        --total_steps 38400000
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict

import numpy as np
import torch

from flowstate_tpu_torch.analysis.mbar import (
    mbar_free_energies, mbar_log_weights,
)
from flowstate_tpu_torch.analysis.plots import (
    plot_avg_free_energy, plot_avg_x_coordinate,
    plot_multiple_avg_x_coordinates, plot_state_histogram,
    plot_well_statistics,
)
from flowstate_tpu_torch.analysis.wells import (
    calculate_well_statistics, classify_particles, well_counts_device,
)
from flowstate_tpu_torch.experiments.common import (
    build_system, plot_wells, sector_counts, setup_experiment,
    write_evidence,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.initialise import init_split_wells
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import batched_energy_virial
from flowstate_tpu_torch.mcmc.tempering import (
    chain_betas, init_tempered_state, run_replica_exchange,
    temperature_ladder,
)
from flowstate_tpu_torch.training.cycles import cycle_generator
from flowstate_tpu_torch.utils.checkpoint import (
    chain_state_from_tree, chain_state_tree, latest_checkpoint,
    restore_checkpoint, save_checkpoint,
)
from flowstate_tpu_torch.utils.config import ExperimentConfig, tempering_config

SWAP_SEED_OFFSET = 1   # segment s draws its swaps from (master_seed + 1, s)
MBAR_MAX_POOL = 500_000
MBAR_BLOCKS = 5


def _segment_paths(directory: str):
    return sorted(glob.glob(os.path.join(directory, "segments",
                                         "seg_*.npz")))


def schedule(config: ExperimentConfig, total_production_steps: int):
    """``(rounds_per_segment, num_segments)`` of a run: the cold replica's
    budget split over walkers, as the baseline driver, in rounds of
    ``pt_moves_per_round`` moves."""
    rounds_total = ((int(total_production_steps) // config.num_chains)
                    // config.pt_moves_per_round)
    seg_len = min(config.pt_segment_rounds, max(rounds_total, 1))
    return seg_len, max(1, rounds_total // seg_len)


def default_equilibration_steps(num_particles: int) -> int:
    """Moves of per-replica equilibration when none are asked for: 5000,
    or 20000 for N > 12 (half-lattice starts need more)."""
    return 20000 if num_particles > 12 else 5000


def initial_state(config: ExperimentConfig, spec, betas: torch.Tensor,
                  walker_positions: np.ndarray = None):
    """The driver's start on the device of ``betas``: every replica from
    the same (W, N, 2) batch of walkers (by default the alternating-well
    batch of ``init_split_wells``), then every replica equilibrated at its
    own beta for ``equilibration_steps`` moves (one move-kernel launch per
    adjustment block, the step adapted every ``adjusting_frequency``
    moves)."""
    r, w, n = config.pt_replicas, config.num_chains, config.num_particles
    if walker_positions is None:
        walker_positions, _ = init_split_wells(w, n, config.rho)
    positions = torch.as_tensor(
        np.broadcast_to(walker_positions, (r, w, n, 2)).copy(),
        dtype=torch.float32, device=betas.device)
    state = init_tempered_state(spec, positions, config.master_seed,
                                config.initial_max_displacement)
    beta_c = chain_betas(betas, w)
    return run_equilibration(
        spec, beta_c, state, config.equilibration_steps,
        config.adjusting_frequency,
        move_fn=lambda s, k: run_moves_auto(spec, beta_c, s, k))


def well_record(config: ExperimentConfig):
    """The per-round record of every replica: ``(n_a, n_b, energy)``, each
    (R, W), the well counts by ``well_counts_device``."""
    def record_fn(view):
        n_a, n_b = well_counts_device(view.positions, config.half_box,
                                      config.r0)
        return n_a, n_b, view.energy

    return record_fn


def _log_ratio(wgt: np.ndarray, num: np.ndarray, den: np.ndarray) -> float:
    return float(np.log(max((wgt * num).sum(), 1e-300)
                        / max((wgt * den).sum(), 1e-300)))


def mbar_well_delta_f(betas: torch.Tensor, n_a: np.ndarray, n_b: np.ndarray,
                      energy: np.ndarray, num_particles: int, burn: int,
                      max_pool: int = MBAR_MAX_POOL) -> Dict:
    """The driver's MBAR analysis of (T, R, W) records: after ``burn``
    rounds, the rounds thinned by a stride that caps the pool at about
    ``max_pool`` samples (the JAX driver's rule), f_k in float64 on the
    device of ``betas``, the cold state's weights, and from them the
    particle-level ΔF ln(sum n_B / sum n_A), its SEM over 5 round blocks
    (shared f_k) and the sector ΔF ln P(all B) / P(all A)."""
    t_rounds, r, w = energy.shape
    stride = max(1, (t_rounds - burn) * r * w // max_pool)
    na_t, nb_t, e_t = (a[burn:][::stride] for a in (n_a, n_b, energy))
    all_a_t, all_b_t = na_t == num_particles, nb_t == num_particles
    e_pool = e_t.transpose(1, 0, 2).reshape(r, -1)        # (R, M)
    m = e_pool.shape[1]
    dev = betas.device
    u_kn = (betas.to(torch.float64)[:, None]
            * torch.as_tensor(e_pool.reshape(-1), dtype=torch.float64,
                              device=dev)[None, :])
    n_k = torch.full((r,), float(m), dtype=torch.float64, device=dev)
    f_k = mbar_free_energies(u_kn, n_k, num_iters=500)
    log_w = mbar_log_weights(u_kn, n_k, f_k, 0).cpu().numpy()
    wgt = np.exp(log_w - log_w.max())
    wgt /= wgt.sum()

    def pool(a):
        return a.transpose(1, 0, 2).reshape(-1)

    na_pool, nb_pool = pool(na_t), pool(nb_t)
    blocks = []
    idx = np.arange(r * m).reshape(r, -1, w)
    t_post = idx.shape[1]
    for b in range(MBAR_BLOCKS):
        sel = np.zeros(r * m, bool)
        sel[idx[:, b * t_post // MBAR_BLOCKS:
                (b + 1) * t_post // MBAR_BLOCKS].reshape(-1)] = True
        blocks.append(_log_ratio(np.where(sel, wgt, 0.0), nb_pool, na_pool))
    return {"df_particle_mbar": _log_ratio(wgt, nb_pool, na_pool),
            "df_particle_mbar_sem": float(np.std(blocks)
                                          / np.sqrt(len(blocks))),
            "df_sector_mbar": _log_ratio(wgt, pool(all_b_t), pool(all_a_t)),
            "f_k": f_k.cpu().numpy(), "pooled": r * m, "stride": stride}


def run(config: ExperimentConfig, total_production_steps: int = 10_000_000,
        resume: bool = False, device="cuda") -> Dict:
    """Run the PT experiment on ``device``; returns a results summary
    (the JAX driver's keys, with ``state``, the final tempered state,
    ``segment_s`` and ``energy_drift`` per segment run here, and
    ``wall_s``)."""
    if config.sampler != "pt":
        raise ValueError(f"tempering driver requires sampler='pt', got "
                         f"{config.sampler!r}")
    if config.pt_replicas < 2:
        raise ValueError("pt_replicas must be >= 2")
    device = torch.device(device)
    t_start = time.perf_counter()
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    figures = [plot_wells(config, spec, directory)]
    os.makedirs(os.path.join(directory, "segments"), exist_ok=True)

    r, w, n = config.pt_replicas, config.num_chains, config.num_particles
    betas = temperature_ladder(config.temperature, config.pt_t_hot, r,
                               config.pt_ladder, device)
    mpr = config.pt_moves_per_round
    seg_len, num_segments = schedule(config, total_production_steps)
    logger.info("PT: %d replicas x %d walkers, T in [%g, %g], "
                "%d rounds x %d moves (%d segments of %d)",
                r, w, config.temperature, config.pt_t_hot,
                num_segments * seg_len, mpr, num_segments, seg_len)

    ckpt_dir = os.path.join(directory, "checkpoints")
    seg_done, state = 0, None
    latest = latest_checkpoint(ckpt_dir) if resume else None
    if latest is not None:
        seg_done, path = latest
        tree, _ = restore_checkpoint(path)
        state = chain_state_from_tree(tree["chains"], device)
        logger.info("resumed from %s (%d segments done)", path, seg_done)
    else:
        state = initial_state(config, spec, betas)
        metrics.log("equilibrated", replicas=r, walkers=w,
                    steps=config.equilibration_steps)
    record_fn = well_record(config)

    segment_s, drifts = [], []
    for seg in range(seg_done, num_segments):
        t0 = time.perf_counter()
        res = run_replica_exchange(
            spec, betas, state,
            cycle_generator(device, config.master_seed + SWAP_SEED_OFFSET,
                            seg),
            seg_len, mpr, record="cold", record_fn=record_fn)
        state = res.state
        na, nb, e_all = res.extras
        np.savez_compressed(
            os.path.join(directory, "segments", f"seg_{seg:04d}.npz"),
            cold_positions=res.cold_positions.cpu().numpy().astype(np.float32),
            n_a=na.cpu().numpy().astype(np.int16),
            n_b=nb.cpu().numpy().astype(np.int16),
            energy=e_all.cpu().numpy().astype(np.float32),
            edge_acceptance=res.edge_acceptance.cpu().numpy())
        # the tracked energies against a recompute: logged, not applied
        exact, _ = batched_energy_virial(spec, state.positions)
        drift = float((state.energy.double() - exact.double()).abs().max())
        save_checkpoint(ckpt_dir, seg + 1, {"chains": chain_state_tree(state)},
                        metadata={"segment": seg + 1,
                                  "rounds_done": (seg + 1) * seg_len})
        dt = time.perf_counter() - t0
        segment_s.append(dt)
        drifts.append(drift)
        edge = res.edge_acceptance.cpu().numpy()
        metrics.log("segment_done", segment=seg + 1, of=num_segments,
                    wall_s=round(dt, 2), energy_drift=drift,
                    edge_acceptance=[round(float(a), 3) for a in edge])
        logger.info("segment %d/%d done (%.1f s, energy drift %.3g)",
                    seg + 1, num_segments, dt, drift)

    # ---- gather observables ---------------------------------------------
    segs = [np.load(p) for p in _segment_paths(directory)]
    cold_pos = np.concatenate([s["cold_positions"] for s in segs])
    na = np.concatenate([s["n_a"] for s in segs])          # (T, R, W)
    nb = np.concatenate([s["n_b"] for s in segs])
    e_all = np.concatenate([s["energy"] for s in segs])    # (T, R, W)
    edge_acc = np.mean(np.stack([s["edge_acceptance"] for s in segs]),
                       axis=0)
    t_rounds = cold_pos.shape[0]
    burn = t_rounds // 3

    # per-walker well statistics and ΔF on the cold replica's trajectory
    configs_w = cold_pos.transpose(1, 0, 2, 3)             # (W, T, N, 2)
    free_energy_array = []
    for run_idx in range(w):
        avg_x, p_a, p_b, d_f, runs = calculate_well_statistics(
            configs_w[run_idx], 0, config.half_box, config.r0)
        free_energy_array.append(d_f)
        if run_idx < 10:
            run_dir = os.path.join(directory, "mc_runs",
                                   f"run_{run_idx + 1:03d}")
            os.makedirs(run_dir, exist_ok=True)
            figures += [
                plot_well_statistics(avg_x, p_a, p_b, d_f, runs,
                                     config.half_box, run_dir),
                plot_avg_x_coordinate(configs_w[run_idx], run_dir,
                                      config.half_box, run_idx + 1)]
    figures.append(plot_multiple_avg_x_coordinates(list(configs_w[:10]),
                                                   directory))
    svg, _, final_mean, final_sem, final_std = plot_avg_free_energy(
        np.asarray(free_energy_array), directory)
    figures.append(svg)
    logger.info("Final mean delta F = %s +- %s (occupancy, cold replica)",
                final_mean, final_sem)

    # the cold replica's particle-level ΔF, and its sector ΔF ln P(all B) /
    # P(all A) from the recorded counts
    df_cold = float(np.log(max(nb[burn:, 0].sum(), 1.0)
                           / max(na[burn:, 0].sum(), 1.0)))
    all_a, all_b = na == n, nb == n
    df_sector_cold = float(np.log(max(all_b[burn:, 0].sum(), 1.0)
                                  / max(all_a[burn:, 0].sum(), 1.0)))
    mb = mbar_well_delta_f(betas, na, nb, e_all, n, burn)
    df_mbar, df_mbar_sem = mb["df_particle_mbar"], mb["df_particle_mbar_sem"]
    df_sector_mbar = mb["df_sector_mbar"]
    logger.info("MBAR delta F = %.4f +- %.4f (pooled %d samples; "
                "cold-only %.4f); sector dF cold=%.4f mbar=%.4f",
                df_mbar, df_mbar_sem, mb["pooled"], df_cold, df_sector_cold,
                df_sector_mbar)
    metrics.log("free_energy", occupancy_mean=final_mean,
                occupancy_sem=final_sem, df_particle_cold=df_cold,
                df_particle_mbar=df_mbar, df_particle_mbar_sem=df_mbar_sem,
                df_sector_cold=df_sector_cold,
                df_sector_mbar=df_sector_mbar)

    cls = classify_particles(cold_pos[burn:].reshape(-1, n, 2),
                             config.half_box, config.r0)
    figures.append(plot_state_histogram(cls, directory))
    if None in figures:
        logger.info("%d figures not drawn (matplotlib cannot be imported); "
                    "their *_data.json are written", figures.count(None))

    write_evidence(config, {
        "driver": "tempering",
        "sampler": "pt",
        "ladder": {"replicas": r, "t_hot": config.pt_t_hot,
                   "kind": config.pt_ladder,
                   "betas": [round(float(b), 5) for b in betas.cpu()]},
        "rounds": t_rounds, "moves_per_round": mpr, "walkers": w,
        "edge_acceptance": [round(float(a), 4) for a in edge_acc],
        "delta_f_mean": final_mean, "delta_f_sem": final_sem,
        "delta_f_std": final_std,
        "df_particle_cold": round(df_cold, 4),
        "df_particle_mbar": round(df_mbar, 4),
        "df_particle_mbar_sem": round(df_mbar_sem, 4),
        "df_sector_cold": round(df_sector_cold, 4),
        "df_sector_mbar": round(df_sector_mbar, 4),
        "mbar_f_k": [round(float(x), 3) for x in mb["f_k"]],
        # every walker's cold trajectory, (W, T, N, 2), its first half
        # burnt (the JAX driver passes the (T, W) stack after its burn, so
        # its counts drop half the walkers instead: ROADMAP R9)
        "sector_counts": sector_counts(configs_w, config.half_box,
                                       config.r0),
    }, device)
    metrics.close()
    return {"delta_f_mean": final_mean, "delta_f_sem": final_sem,
            "df_particle_cold": df_cold, "df_particle_mbar": df_mbar,
            "df_particle_mbar_sem": df_mbar_sem,
            "df_sector_cold": df_sector_cold,
            "df_sector_mbar": df_sector_mbar,
            "edge_acceptance": edge_acc.tolist(), "directory": directory,
            "rounds": t_rounds, "state": state, "segment_s": segment_s,
            "energy_drift": drifts,
            "wall_s": time.perf_counter() - t_start}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Parallel-tempering production experiment")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--num_chains", type=int, default=50,
                        help="walkers per replica")
    parser.add_argument("--num_particles", type=int, default=3)
    parser.add_argument("--total_steps", type=int, default=10_000_000,
                        help="cold-replica local-move budget (split over "
                             "walkers, as the baseline driver)")
    parser.add_argument("--replicas", type=int, default=10)
    parser.add_argument("--t_hot", type=float, default=10.0)
    parser.add_argument("--moves_per_round", type=int, default=150)
    parser.add_argument("--ladder", choices=("geometric", "linear"),
                        default="geometric")
    parser.add_argument("--segment_rounds", type=int, default=200)
    parser.add_argument("--equilibration_steps", type=int, default=None,
                        help="default: 5000, or 20000 for N > 12 "
                             "(half-lattice starts need more)")
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    equil = args.equilibration_steps
    if equil is None:
        equil = default_equilibration_steps(args.num_particles)
    config = tempering_config(
        experiment_id=args.experiment_id, num_chains=args.num_chains,
        num_particles=args.num_particles, output_dir=args.output_dir,
        pt_replicas=args.replicas, pt_t_hot=args.t_hot,
        pt_moves_per_round=args.moves_per_round, pt_ladder=args.ladder,
        pt_segment_rounds=args.segment_rounds,
        equilibration_steps=equil)
    out = run(config, total_production_steps=args.total_steps,
              resume=args.resume, device=args.device)
    print({k: v for k, v in out.items()
           if k not in ("edge_acceptance", "state")})


if __name__ == "__main__":
    main()
