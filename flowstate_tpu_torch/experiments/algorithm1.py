"""Hybrid Algorithm 1: train the flow once, then sample with big moves.

Port of ``flowstate_tpu/experiments/algorithm1.py``:

  Phase A  init and equilibration (``init_and_equilibrate``: the move
           kernel K1, the pair-energy kernel K2 for the initial energies)
  Phase B  training samples from production (``run_production_kernel``:
           one K1 launch and one K2 resync per sample), shifted to the
           flow's centred frame; or a premade NPZ
  Phase C  the flow built and trained (forward KLD), saved, and its
           samples' heatmap and pair correlation
  Phase D  testing: per round, ``big_move_interval`` local moves of every
           chain in one K1 launch, then one flow proposal per chain
           (``sample_and_log_prob``) judged by ``apply_big_moves``, whose
           proposal energies are one K2 launch; then the acceptance
           history, well statistics and ΔF estimators

With ``blocked_k > 0`` (the JAX driver's :128-162, 205-242) Phase C trains
the conditional flow of the blocked moves instead (depth ``blocked_K``,
the Fourier context with ``m_max = blocked_context_modes``; no flow
samples, since it has no context-free sampler), and each round of Phase D
is one K1 launch and then ``max(1, N // blocked_k)`` blocked moves, each
one paired flow pass and one K2 launch (``mcmc/blocked.py``).

The testing loop is one Python loop; its results follow the JAX
package's fused and host-loop paths, which give equal results
(``fused_testing`` is kept as a config field and changes nothing here).
Each round's accept flags and positions stay on the device and come to
the host once, after the last round.

    python -m flowstate_tpu_torch.experiments.algorithm1 --experiment_id X \\
        --device cuda
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Dict

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_acceptance_rate, plot_avg_free_energy, plot_avg_x_coordinate,
    plot_frequency_heatmap, plot_loss, plot_multiple_avg_x_coordinates,
    plot_pair_correlation, plot_well_statistics,
)
from flowstate_tpu_torch.analysis.rdf import calculate_pair_correlation
from flowstate_tpu_torch.analysis.wells import (
    calculate_well_statistics, classify_particles,
)
from flowstate_tpu_torch.experiments.common import (
    _thin, build_blocked_flow, build_system, init_and_equilibrate,
    log_blocked_depth, plot_wells, sector_counts, setup_experiment,
    write_evidence,
)
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc.blocked import blocked_big_moves
from flowstate_tpu_torch.mcmc.cuda_metropolis import (
    run_moves_auto, run_production_kernel,
)
from flowstate_tpu_torch.mcmc.hybrid import apply_big_moves, to_box_frame
from flowstate_tpu_torch.training import TrainConfig, train, train_blocked
from flowstate_tpu_torch.utils.config import ExperimentConfig, algorithm1_config
from flowstate_tpu_torch.utils.profiling import annotate


def collect_training_samples(config: ExperimentConfig, spec, state):
    """Phase B: ``initial_training_num_samples / C`` samples per chain, one
    every ``sampling_frequency`` moves, as (C*T, N, 2) host configurations
    in the flow's centred frame."""
    samples_per_chain = config.initial_training_num_samples // config.num_chains
    state, obs = run_production_kernel(spec, config.beta, state,
                                       samples_per_chain,
                                       config.sampling_frequency)
    configs_mc = obs.positions.cpu().numpy().reshape(
        -1, config.num_particles, 2)
    return state, configs_mc - config.half_box, obs


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_testing(config: ExperimentConfig, spec, state, model,
                generator: torch.Generator, context_fn=None):
    """Phase D's rounds: per round one K1 launch of ``big_move_interval``
    moves for all chains, then one flow proposal per chain and its
    Metropolis-Hastings verdict (one K2 launch), or with ``blocked_k > 0``
    ``N // blocked_k`` blocked moves of ``model``, a conditional flow on
    ``context_fn``'s context (one K2 launch each).  Returns the final
    state and, on the host, the (R, C) accept flags (the blocked moves'
    accepted fraction per round) and (R, C, N, 2) positions after every
    round.  Each round is a span ``a1.round`` (``utils/profiling.py``)."""
    c, rounds = config.num_chains, config.big_move_attempts
    dev = state.device
    blocked = config.blocked_k > 0
    bpr = max(1, config.num_particles // config.blocked_k) if blocked else 1
    accepted = torch.zeros((rounds, c), device=dev,
                           dtype=torch.float32 if blocked else torch.bool)
    positions = torch.empty((rounds, *state.positions.shape),
                            dtype=state.positions.dtype, device=dev)
    for r in range(rounds):
        with annotate("a1.round"):
            state = run_moves_auto(spec, config.beta, state,
                                   config.big_move_interval)
            if blocked:
                for _ in range(bpr):
                    result = blocked_big_moves(
                        spec, config.beta, state, model, config.half_box,
                        config.blocked_k, generator, context_fn)
                    state = result.state
                    accepted[r] += result.accepted
                accepted[r] /= bpr
            else:
                with torch.no_grad():
                    prop_flat, log_q_new = model.sample_and_log_prob(
                        c, generator)
                u = torch.rand(c, generator=generator, device=dev)
                result = apply_big_moves(
                    spec, config.beta, state,
                    to_box_frame(prop_flat, config.num_particles,
                                 config.half_box),
                    log_q_new, model, config.half_box, u)
                state = result.state
                accepted[r] = result.accepted
            positions[r] = state.positions
    return state, accepted.cpu().numpy(), positions.cpu().numpy()


def train_global_flow(config: ExperimentConfig, train_configs, train_cfg,
                      nf_dir: str, figures: list, metrics, logger, device):
    """Phase C's global flow: built, trained on the centred
    configurations, saved, and its samples' heatmap and pair correlation
    drawn.  Returns the flow and its epochs' losses."""
    model = build_circular_flow(
        config.num_particles, config.num_dim, config.half_box, K=config.K,
        hidden_units=config.hidden_units, num_bins=config.num_bins,
        num_blocks=config.n_blocks, net_type=config.net_type,
        generator=_generator(device, config.master_seed + 1), device=device)
    logger.info("Model prepared with %d particles and %d dimensions!",
                config.num_particles, config.num_dim)
    data = torch.as_tensor(
        train_configs.reshape(len(train_configs), -1).astype(np.float32),
        device=device)
    _, _, _, loss_epoch = train(
        model, data, train_cfg, _generator(device, config.master_seed + 2),
        epoch_callback=lambda e, l: metrics.log("train_epoch", epoch=e,
                                                loss=l))
    figures.append(plot_loss(loss_epoch, nf_dir))
    model.save(os.path.join(nf_dir,
                            "initial_model_circularspline_res_dense.pkl"))
    with torch.no_grad():
        eval_samples = model.sample(
            min(config.num_samples_for_analysis, 50000),
            _generator(device, 99))
    eval_np = eval_samples.cpu().numpy().reshape(-1, config.num_particles, 2)
    np.save(os.path.join(nf_dir, "samples.npy"), eval_np + config.half_box)
    figures.append(plot_frequency_heatmap(eval_np, nf_dir, config.half_box))
    r_vals, g_r = calculate_pair_correlation(
        eval_np, config.num_particles, config.half_box,
        dr=config.half_box / 50)
    figures.append(plot_pair_correlation(r_vals, g_r, nf_dir))
    return model, loss_epoch


def run(config: ExperimentConfig, premade_data_path: str = None,
        device="cuda") -> Dict:
    """Run Algorithm 1 on ``device``.

    ``premade_data_path``: an NPZ of configurations in the centred frame
    ((T, N, 2), under ``configs`` or its first array) used instead of
    Phase B.
    """
    device = torch.device(device)
    blocked = config.blocked_k > 0
    phase_s = {}
    t0 = time.perf_counter()
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    figures = [plot_wells(config, spec, directory)]

    # Phase A ------------------------------------------------------------
    state = init_and_equilibrate(config, spec, device, logger)
    metrics.log("equilibrated", chains=config.num_chains)
    _sync(device)
    phase_s["A"] = time.perf_counter() - t0

    # Phase B ------------------------------------------------------------
    t = time.perf_counter()
    if premade_data_path is not None:
        npz = np.load(premade_data_path)
        arr = npz["configs"] if "configs" in npz.files else npz[npz.files[0]]
        train_configs = np.asarray(arr).reshape(-1, config.num_particles, 2)
        logger.info("loaded %d premade training samples from %s",
                    len(train_configs), premade_data_path)
    else:
        state, train_configs, _ = collect_training_samples(config, spec,
                                                           state)
    logger.info("collected %d training samples", len(train_configs))
    unique = np.unique(train_configs.reshape(len(train_configs), -1), axis=0)
    logger.info("Total unique samples: %d", len(unique))
    metrics.log("samples_collected", total=len(train_configs),
                unique=len(unique))
    phase_s["B"] = time.perf_counter() - t

    # Phase C ------------------------------------------------------------
    t = time.perf_counter()
    nf_dir = os.path.join(directory, "training_rounds",
                          "initial_training_round")
    os.makedirs(nf_dir, exist_ok=True)
    train_cfg = TrainConfig(batch_size=config.batch_size,
                            epochs=config.epochs, lr=config.lr,
                            weight_decay=config.weight_decay)
    context_fn = None
    if blocked:
        model, context_fn = build_blocked_flow(
            config, _generator(device, config.master_seed + 1), device)
        logger.info("Conditional model prepared: k=%d block of %d "
                    "particles", config.blocked_k, config.num_particles)
        log_blocked_depth(config, logger)
        box_frame = torch.as_tensor(
            (train_configs + config.half_box).astype(np.float32),
            device=device)
        _, _, loss_epoch = train_blocked(
            model, box_frame, config.blocked_k, config.half_box, train_cfg,
            _generator(device, config.master_seed + 2),
            context_fn=context_fn)
        for e, l in enumerate(loss_epoch):
            metrics.log("train_epoch", epoch=e, loss=l)
        figures.append(plot_loss(loss_epoch, nf_dir))
        model.save(os.path.join(nf_dir,
                                "initial_model_blocked_conditional.pkl"))
    else:
        model, loss_epoch = train_global_flow(
            config, train_configs, train_cfg, nf_dir, figures, metrics,
            logger, device)
    _sync(device)
    phase_s["C"] = time.perf_counter() - t

    # Phase D ------------------------------------------------------------
    results: Dict = {"directory": directory,
                     "final_loss": loss_epoch[-1] if loss_epoch else None,
                     "phase_s": phase_s}
    if config.testing:
        t = time.perf_counter()
        c = config.num_chains
        if blocked:
            logger.info("testing phase: %d rounds of %d local moves and %d "
                        "blocked moves of k=%d", config.big_move_attempts,
                        config.big_move_interval,
                        max(1, config.num_particles // config.blocked_k),
                        config.blocked_k)
        else:
            logger.info("testing phase: %d rounds of %d local moves and one "
                        "big move (fused_testing=%s changes nothing in this "
                        "port)", config.big_move_attempts,
                        config.big_move_interval, config.fused_testing)
        state, accepted_rounds, positions_rounds = run_testing(
            config, spec, state, model,
            _generator(device, config.master_seed + 3), context_fn)
        phase_s["D_rounds"] = time.perf_counter() - t
        testing_positions = list(positions_rounds)
        acc_cum = np.cumsum(accepted_rounds.sum(axis=1))
        rounds = np.arange(1, config.big_move_attempts + 1)
        p_acc_history = [0.0] + list(acc_cum / (c * rounds))
        steps_history = [0] + list(rounds * config.big_move_interval * c)
        for r in range(100, config.big_move_attempts + 1, 100):
            logger.info("big-move round %d/%d: p_acc=%.4f", r,
                        config.big_move_attempts, p_acc_history[r])
            metrics.log("big_move_round", round=r, p_acc=p_acc_history[r])
        logger.info("testing phase done: p_acc=%.4f", p_acc_history[-1])

        figures.append(plot_acceptance_rate(
            p_acc_history, directory, x_values=steps_history,
            xlabel="MCMC Steps", base_filename="nf_acceptance_rate"))
        with open(os.path.join(directory, "acceptance_rate_data.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["MCMC_Steps", "Acceptance_Rate"])
            for s, a in zip(steps_history, p_acc_history):
                w.writerow([s, a])

        # well statistics over the testing trajectory, per chain
        testing_stack = np.stack(testing_positions, axis=1)  # (C, T, N, 2)
        free_energy_array = []
        for run_idx in range(c):
            avg_x, p_a, p_b, d_f, runs = calculate_well_statistics(
                testing_stack[run_idx], 0, config.half_box, config.r0)
            free_energy_array.append(d_f)
            run_dir = os.path.join(directory, "mc_runs",
                                   f"run_{run_idx + 1:03d}")
            os.makedirs(run_dir, exist_ok=True)
            if run_idx < 10:
                figures += [
                    plot_well_statistics(avg_x, p_a, p_b, d_f, runs,
                                         config.half_box, run_dir),
                    plot_avg_x_coordinate(testing_stack[run_idx], run_dir,
                                          config.half_box, run_idx + 1)]
            np.save(os.path.join(run_dir, "mc_run_testing_configs.npy"),
                    testing_stack[run_idx])
        if c >= 10:
            figures.append(plot_multiple_avg_x_coordinates(
                list(testing_stack[:10]), directory))
        svg, _, fm, fsem, fstd = plot_avg_free_energy(
            np.asarray(free_energy_array), directory)
        figures.append(svg)
        logger.info("Final mean delta F = %s", fm)
        logger.info("Final standard error delta F = %s", fsem)

        # equilibrium window: the second half of every chain
        half = testing_stack.shape[1] // 2
        eq_df = []
        for run_idx in range(c):
            _, _, _, df_eq, _ = calculate_well_statistics(
                testing_stack[run_idx], half, config.half_box, config.r0)
            eq_df.append(df_eq[-1])
        eq_df = np.asarray(eq_df)
        finite = eq_df[np.isfinite(eq_df) & (eq_df != 0.0)]
        eq_mean = float(np.mean(finite)) if len(finite) else float("nan")
        eq_sem = (float(np.std(finite) / np.sqrt(len(finite)))
                  if len(finite) else float("nan"))
        logger.info("Equilibrium-window delta F = %s +- %s", eq_mean, eq_sem)

        # particle-level ΔF = ln(E[n_B] / E[n_A]) over the same window
        cls_eq = classify_particles(testing_stack[:, half:].reshape(
            -1, config.num_particles, 2), config.half_box, config.r0)
        n_a_eq = float(np.sum(cls_eq == 0))
        n_b_eq = float(np.sum(cls_eq == 1))
        df_particle = float(np.log(max(n_b_eq, 1.0) / max(n_a_eq, 1.0)))
        logger.info("Particle-level delta F (eq window) = %.4f", df_particle)
        metrics.log("free_energy", mean=fm, sem=fsem, std=fstd,
                    eq_mean=eq_mean, eq_sem=eq_sem, df_particle=df_particle)
        phase_s["D"] = time.perf_counter() - t
        results.update({"delta_f_mean": fm, "delta_f_sem": fsem,
                        "delta_f_std": fstd, "delta_f_eq_mean": eq_mean,
                        "delta_f_eq_sem": eq_sem, "df_particle": df_particle,
                        "big_move_acceptance": p_acc_history[-1]})
        write_evidence(config, {
            "driver": "algorithm1",
            "delta_f_mean": fm, "delta_f_sem": fsem, "delta_f_std": fstd,
            "delta_f_eq_mean": eq_mean, "delta_f_eq_sem": eq_sem,
            "df_particle": df_particle,
            "delta_f_per_chain_final": [float(f[-1]) if len(f) else None
                                        for f in free_energy_array],
            "big_move_acceptance": p_acc_history[-1],
            "p_acc_history": _thin(p_acc_history),
            "steps_history": _thin(steps_history),
            "sector_counts": sector_counts(testing_stack, config.half_box,
                                           config.r0),
            "phase_s": phase_s,
        }, device)
    if None in figures:
        logger.info("%d figures not drawn (matplotlib cannot be imported); "
                    "their *_data.json are written", figures.count(None))
    metrics.close()
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description="Hybrid Algorithm 1")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args()
    config = algorithm1_config(experiment_id=args.experiment_id,
                               output_dir=args.output_dir)
    run(config, device=args.device)


if __name__ == "__main__":
    main()
