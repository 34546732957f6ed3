"""Standalone NVT MCMC CLI — the reference ``MCMC/main.py`` equivalent.

Port of ``flowstate_tpu/experiments/single_run.py``: the same flags and
defaults, plus ``--device`` (default ``cuda``; the run stops if there is no
card, it never carries on on the CPU unless ``--device cpu`` asks).
Pipeline: init → plot potential (with wells) → equilibrate → produce →
NPZ of centred production configs → CSV of chain 0's samples →
visualisation → acceptance summary.  Where matplotlib cannot be imported
(the card's machine has none), the figures are not written and one line
says so for each; the NPZ, the CSV and the summary are the same.

On the card, equilibration and production run their move segments through
the move kernel (``cuda_metropolis.run_moves_auto``), and the pair-energy
kernel computes the initial energies and resyncs energy and virial before
every production sample (``run_production_kernel``).  The JAX CLI tracks
the virial move by move instead; the two agree within the tracked drift.

    python -m flowstate_tpu_torch.experiments.single_run --temperature 1.0 \\
        --num_particles 1024 --initial_rho 0.3 --equilibration_steps 2000 \\
        --production_steps 8000 --sampling_frequency 200 \\
        --adjusting_frequency 500 --output_path results --experiment_id X \\
        --seed 0 --num_chains 128 --device cuda
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_potential, visualise_simulation,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import (
    run_moves_auto, run_production_kernel,
)
from flowstate_tpu_torch.mcmc.initialise import (
    initialise_fcc, initialise_fcc_left_half, initialise_fcc_right_half,
    initialise_low_left, initialise_low_right,
)
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.ops import SystemSpec


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Run NVT Monte Carlo simulation")
    parser.add_argument("--temperature", type=float, required=True)
    parser.add_argument("--num_particles", type=int, default=64)
    parser.add_argument("--initial_rho", type=float, required=True)
    parser.add_argument("--aspect_ratio", type=float, default=1.0)
    parser.add_argument("--visualise", action="store_true")
    parser.add_argument("--checking", action="store_true")
    parser.add_argument("--equilibration_steps", type=int, required=True)
    parser.add_argument("--production_steps", type=int, required=True)
    parser.add_argument("--sampling_frequency", type=int, required=True)
    parser.add_argument("--adjusting_frequency", type=int, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--time_calc", action="store_true")
    parser.add_argument("--num_wells", type=int, choices=[0, 1, 2], default=0)
    parser.add_argument("--V0_list", type=float, nargs="+",
                        default=[-0.5, -0.5])
    parser.add_argument("--k", type=float, default=10.0)
    parser.add_argument("--r0", type=float, default=1.0)
    parser.add_argument("--initialisation_type", type=str,
                        choices=["all", "left_half", "right_half",
                                 "low_left", "low_right"],
                        default="all")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--initial_max_displacement", type=float, default=0.1)
    parser.add_argument("--num_chains", type=int, default=1,
                        help="independent replicas run as one device batch")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the chains (cuda or cpu)")
    return parser.parse_args(argv)


def _initialise(args):
    n = args.num_particles
    # low-N init selection mirrors main.py:62-109
    if args.initialisation_type == "low_left" or (
            args.initialisation_type == "left_half" and 2 <= n <= 12):
        return initialise_low_left(n, args.initial_rho, args.aspect_ratio)
    if args.initialisation_type == "low_right" or (
            args.initialisation_type == "right_half" and 2 <= n <= 12):
        return initialise_low_right(n, args.initial_rho, args.aspect_ratio)
    if args.initialisation_type == "left_half":
        return initialise_fcc_left_half(n, args.initial_rho,
                                        args.aspect_ratio)
    if args.initialisation_type == "right_half":
        return initialise_fcc_right_half(n, args.initial_rho,
                                         args.aspect_ratio)
    return initialise_fcc(n, args.initial_rho, args.aspect_ratio)


def _not_written(figure: str) -> None:
    print(f"{figure}.png/.svg not written: matplotlib cannot be imported",
          flush=True)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    num_samples = args.production_steps // args.sampling_frequency
    if num_samples < 1:
        raise ValueError(
            f"--production_steps {args.production_steps} gives no sample "
            f"every {args.sampling_frequency} moves")
    out_dir = os.path.join(args.output_path, args.experiment_id)
    os.makedirs(out_dir, exist_ok=True)

    particles, box = _initialise(args)
    spec = SystemSpec.create(args.num_particles, box,
                             num_wells=args.num_wells,
                             V0_list=args.V0_list, r0=args.r0, k=args.k)
    beta = 1.0 / args.temperature

    if args.num_wells > 0 and plot_potential(
            box.size_x, box.size_y, args.V0_list, args.r0, args.k,
            args.num_wells, out_dir) is None:
        _not_written("potential")

    batch = np.tile(particles[None], (args.num_chains, 1, 1))
    state = init_chain_state(
        spec, torch.as_tensor(batch, dtype=torch.float32, device=device),
        args.seed, args.initial_max_displacement)
    state = run_equilibration(
        spec, beta, state, args.equilibration_steps,
        args.adjusting_frequency,
        move_fn=lambda s, n: run_moves_auto(spec, beta, s, n))

    # cycle numbers continue after equilibration, as the reference CSVs do
    state, obs = run_production_kernel(spec, beta, state, num_samples,
                                       args.sampling_frequency,
                                       start_cycle=args.equilibration_steps)
    obs = obs.numpy()

    # NPZ of production configs shifted into the centered frame (main.py:179-190)
    configs = obs.positions  # (C, T, N, 2)
    half = np.array([box.size_x / 2.0, box.size_y / 2.0])
    np.savez(os.path.join(out_dir, "production_configs.npz"),
             configs=configs - half)

    # CSV of samples (main.py:200-231); chain 0 for the reference layout
    csv_path = os.path.join(out_dir, "sampled_data.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["cycle_number", "energy_per_particle", "density",
                         "pressure", "box_size_x", "box_size_y",
                         "particle_configuration"])
        for i in range(num_samples):
            writer.writerow([
                int(obs.cycle[0, i]),
                float(obs.energy_per_particle[0, i]),
                float(obs.density[0, i]),
                float(obs.pressure[0, i]),
                float(obs.box_size_x[0, i]),
                float(obs.box_size_y[0, i]),
                configs[0, i].flatten().tolist(),
            ])

    if args.visualise:
        stride = max(1, num_samples // 6)
        if visualise_simulation(list(configs[0, ::stride][:6]), box.size_x,
                                box.size_y, out_dir) is None:
            _not_written("simulation_snapshots")

    attempts = int(state.attempts.sum())
    accepts = int(state.accepts.sum())
    summary = {
        "acceptance_fraction": accepts / max(attempts, 1),
        "final_max_displacement": float(state.max_disp.mean()),
        "mean_pressure": float(np.mean(obs.pressure)),
        "mean_energy_per_particle": float(np.mean(obs.energy_per_particle)),
        "samples_per_chain": num_samples,
        "output_dir": out_dir,
    }
    print(f"Acceptance: {summary['acceptance_fraction']:.4f} "
          f"({accepts}/{attempts})")
    return summary


if __name__ == "__main__":
    main()
