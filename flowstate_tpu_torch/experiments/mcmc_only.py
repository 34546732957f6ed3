"""Baseline MCMC-only experiment (Metropolis sampler).

Port of ``flowstate_tpu/experiments/mcmc_only.py``.  Both equilibration
and production run their move segments through the move kernel on the
card (``cuda_metropolis.run_moves_auto``); production resyncs the energy
and virial before every sample (``run_production_kernel``), because the
kernel does not track the virial.  The analysis (well statistics, ΔF with
its SEM, CSV/NPY dumps, evidence JSON, the figures and their
``*_data.json``) runs on the host.  Without matplotlib (the card's machine)
the figures are not drawn, the log says so, and the ``*_data.json`` files
are written all the same.

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
from flowstate_tpu_torch.experiments.common import (
    build_system, dump_run_artifacts, init_and_equilibrate, plot_wells,
    sector_counts, setup_experiment, write_evidence,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_production_kernel
from flowstate_tpu_torch.utils.config import ExperimentConfig, mcmc_only_config

# Samplers of flowstate_tpu's mcmc_only that the port does not have yet,
# with the ROADMAP item that ports them.
NOT_PORTED = {
    "mala": "ROADMAP queue 1 item 11 (mcmc/mala.py)",
    "hmc": "ROADMAP queue 1 item 11 (mcmc/hmc.py)",
    "pt": "ROADMAP queue 1 item 11 (mcmc/tempering.py, experiments/tempering.py)",
}


def run(config: ExperimentConfig, total_production_steps: int = 10_000_000,
        device="cuda") -> Dict:
    """Run the baseline experiment on ``device``; returns a summary dict."""
    if config.sampler in NOT_PORTED:
        raise NotImplementedError(
            f"sampler {config.sampler!r} is not ported yet: "
            f"{NOT_PORTED[config.sampler]}")
    if config.sampler != "metropolis":
        raise ValueError(f"unknown sampler {config.sampler!r}")
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

    logger.info("production: %d steps/chain -> %d samples/chain (%s)",
                steps_per_chain, num_samples, config.sampler)
    att0 = int(state.attempts.sum())
    acc0 = int(state.accepts.sum())
    state, obs = run_production_kernel(spec, config.beta, state, num_samples,
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


def main() -> None:
    parser = argparse.ArgumentParser(description="Baseline MCMC experiment")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--num_chains", type=int, default=100)
    parser.add_argument("--total_steps", type=int, default=10_000_000)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--sampler", type=str, default="metropolis",
                        choices=("metropolis", "mala", "hmc", "pt"),
                        help="production move kernel; only metropolis is "
                             "ported so far")
    parser.add_argument("--num_leapfrog", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    config = mcmc_only_config(experiment_id=args.experiment_id,
                              num_chains=args.num_chains,
                              output_dir=args.output_dir,
                              sampler=args.sampler,
                              num_leapfrog=args.num_leapfrog)
    run(config, total_production_steps=args.total_steps, device=args.device)


if __name__ == "__main__":
    main()
