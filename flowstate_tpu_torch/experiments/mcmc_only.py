"""Baseline MCMC-only experiment: Metropolis, MALA, HMC or, through the
tempering driver, parallel tempering.

Port of ``flowstate_tpu/experiments/mcmc_only.py``.  Equilibration runs
its move segments through the move kernel on the card
(``cuda_metropolis.run_moves_auto``).  Metropolis production resyncs the
energy and virial before every sample (``run_production_kernel``),
because the kernel does not track the virial.  MALA and HMC start from
the equilibrated state resynced, reset the step size and the adaptation
baseline, adapt (MALA 1000 moves adjusted every 100, HMC 500
trajectories every 50), and run production through
``run_production_with``; an HMC block of n moves is n // num_leapfrog
trajectories (the JAX gradient budget).  Their proposals' energies go
through the pair-energy kernel.  ``sampler="pt"`` runs
``experiments/tempering.py`` with this config.  The analysis (well
statistics, ΔF with its SEM, CSV/NPY dumps, evidence JSON, the figures
and their ``*_data.json``) runs on the host.  Without matplotlib (the
card's machine) the figures are not drawn, the log says so, and the
``*_data.json`` files are written all the same.

    python -m flowstate_tpu_torch.experiments.mcmc_only --experiment_id X \\
        --device cuda
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_avg_free_energy, plot_avg_x_coordinate,
    plot_multiple_avg_x_coordinates, plot_state_histogram,
    plot_well_statistics,
)
from flowstate_tpu_torch.analysis.wells import (
    calculate_well_statistics, classify_particles,
)
from flowstate_tpu_torch.experiments import tempering
from flowstate_tpu_torch.experiments.common import (
    build_system, dump_run_artifacts, init_and_equilibrate, plot_wells,
    sector_counts, setup_experiment, write_evidence,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_production_kernel
from flowstate_tpu_torch.mcmc.hmc import run_hmc, run_hmc_equilibration
from flowstate_tpu_torch.mcmc.mala import run_mala, run_mala_equilibration
from flowstate_tpu_torch.mcmc.metropolis import run_production_with
from flowstate_tpu_torch.mcmc.state import resync_energy
from flowstate_tpu_torch.utils.config import (
    ExperimentConfig, mcmc_only_config, tempering_config,
)

# the step size each gradient sampler adapts from (the JAX driver's)
INITIAL_STEP = {"mala": 0.02, "hmc": 0.05}


def run(config: ExperimentConfig, total_production_steps: int = 10_000_000,
        device="cuda") -> Dict:
    """Run the baseline experiment on ``device``; returns a summary dict
    (``sampler="pt"``: the tempering driver's)."""
    if config.sampler == "pt":
        return tempering.run(config, total_production_steps, device=device)
    if config.sampler not in ("metropolis", "mala", "hmc"):
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if config.sampler == "hmc" and config.num_leapfrog < 1:
        raise ValueError(
            f"num_leapfrog must be >= 1, got {config.num_leapfrog}")
    device = torch.device(device)
    steps_per_chain = int(total_production_steps) // config.num_chains
    num_samples = steps_per_chain // config.sampling_frequency
    if num_samples < 1:
        raise ValueError(
            f"total_production_steps={total_production_steps} gives no "
            f"sample of {config.sampling_frequency} moves per chain")
    t_start = time.perf_counter()
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    figures = [plot_wells(config, spec, directory)]

    state = init_and_equilibrate(config, spec, device, logger)
    metrics.log("equilibrated", chains=config.num_chains,
                steps=config.equilibration_steps)

    beta = config.beta
    if config.sampler in INITIAL_STEP:
        # the move kernel leaves the virial NaN: recompute it, then reset
        # the step size and the adaptation baseline, so that leftover
        # Metropolis counts do not skew the first adaptation block
        state = resync_energy(spec, state)
        state = state.replace(
            max_disp=torch.full_like(state.max_disp,
                                     INITIAL_STEP[config.sampler]),
            prev_attempts=state.attempts, prev_accepts=state.accepts)
    if config.sampler == "mala":
        state = run_mala_equilibration(spec, beta, state, 1000, 100)
        metrics.log("mala_adapted", eps_mean=float(state.max_disp.mean()))
    elif config.sampler == "hmc":
        state = run_hmc_equilibration(spec, beta, state, 500, 50,
                                      config.num_leapfrog)
        metrics.log("hmc_adapted", eps_mean=float(state.max_disp.mean()))

    logger.info("production: %d steps/chain -> %d samples/chain (%s)",
                steps_per_chain, num_samples, config.sampler)
    att0 = int(state.attempts.sum())
    acc0 = int(state.accepts.sum())
    if config.sampler == "mala":
        state, obs = run_production_with(
            spec, beta, state, num_samples, config.sampling_frequency,
            lambda s, m: run_mala(spec, beta, s, m))
    elif config.sampler == "hmc":
        # the gradient budget: m local moves -> m // num_leapfrog
        # trajectories of num_leapfrog + 1 gradients each
        state, obs = run_production_with(
            spec, beta, state, num_samples, config.sampling_frequency,
            lambda s, m: run_hmc(spec, beta, s,
                                 max(1, m // config.num_leapfrog),
                                 config.num_leapfrog))
    else:
        state, obs = run_production_kernel(spec, beta, state, num_samples,
                                           config.sampling_frequency)
    obs = obs.numpy()
    configs = obs.positions                             # (C, T, N, 2)
    prod_att = int(state.attempts.sum()) - att0
    prod_acceptance = (int(state.accepts.sum()) - acc0) / prod_att
    metrics.log("production_done", steps_per_chain=steps_per_chain,
                samples_per_chain=num_samples,
                production_acceptance=prod_acceptance)

    free_energy_array = []
    for run_idx in range(config.num_chains):
        avg_x, p_a, p_b, d_f, runs = calculate_well_statistics(
            configs[run_idx], 0, config.half_box, config.r0)
        free_energy_array.append(d_f)
        if run_idx < 10:
            run_dir = os.path.join(directory, "mc_runs",
                                   f"run_{run_idx + 1:03d}")
            figures += [
                plot_well_statistics(avg_x, p_a, p_b, d_f, runs,
                                     config.half_box, run_dir),
                plot_avg_x_coordinate(configs[run_idx], run_dir,
                                      config.half_box, run_idx + 1)]
        obs_i = type(obs)(**{k: v[run_idx] for k, v in vars(obs).items()})
        dump_run_artifacts(directory, run_idx, obs_i, None)

    figures.append(plot_multiple_avg_x_coordinates(list(configs[:10]),
                                                   directory))
    svg, _, final_mean, final_sem, final_std = plot_avg_free_energy(
        np.asarray(free_energy_array), directory)
    figures.append(svg)
    logger.info("Final mean delta F = %s +- %s", final_mean, final_sem)
    metrics.log("free_energy", mean=final_mean, sem=final_sem, std=final_std)

    cls = classify_particles(configs.reshape(-1, config.num_particles, 2),
                             config.half_box, config.r0)
    figures.append(plot_state_histogram(cls, directory))
    if None in figures:
        logger.info("%d figures not drawn (matplotlib cannot be imported); "
                    "their *_data.json are written", figures.count(None))
    wall_s = time.perf_counter() - t_start

    write_evidence(config, {
        "driver": "mcmc_only",
        "sampler": config.sampler,
        "total_production_steps": int(total_production_steps),
        "samples_per_chain": num_samples,
        "delta_f_mean": final_mean, "delta_f_sem": final_sem,
        "delta_f_std": final_std,
        "delta_f_per_chain_final": [float(f[-1]) for f in free_energy_array],
        "production_acceptance": prod_acceptance,
        "sector_counts": sector_counts(configs, config.half_box, config.r0),
        "wall_s": wall_s,
    }, device)
    metrics.close()

    return {"delta_f_mean": final_mean, "delta_f_sem": final_sem,
            "delta_f_std": final_std, "directory": directory,
            "samples_per_chain": num_samples,
            "production_acceptance": prod_acceptance,
            "energy_per_particle": float(obs.energy_per_particle.mean()),
            "wall_s": wall_s}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Baseline MCMC experiment")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--num_chains", type=int, default=100)
    parser.add_argument("--total_steps", type=int, default=10_000_000)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--sampler", type=str, default="metropolis",
                        choices=("metropolis", "mala", "hmc", "pt"),
                        help="production move kernel (mala and hmc are "
                             "gradient samplers; pt = parallel tempering, "
                             "run by the experiments.tempering driver, "
                             "the recommended sampler for N >= 8)")
    parser.add_argument("--num_leapfrog", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.sampler == "pt":
        config = tempering_config(experiment_id=args.experiment_id,
                                  num_chains=args.num_chains,
                                  output_dir=args.output_dir)
        tempering.run(config, total_production_steps=args.total_steps,
                      device=args.device)
        return
    config = mcmc_only_config(experiment_id=args.experiment_id,
                              num_chains=args.num_chains,
                              output_dir=args.output_dir,
                              sampler=args.sampler,
                              num_leapfrog=args.num_leapfrog)
    run(config, total_production_steps=args.total_steps, device=args.device)


if __name__ == "__main__":
    main()
