"""Parameter-sweep runner over (density, temperature, aspect-ratio) grids.

Port of ``flowstate_tpu/experiments/sweep.py``, the equivalent of the
reference's ``MCMC/scripts/run_experiment_local.py``: the reference fans
out one subprocess per grid point (``:94-105``) with a file-locked CSV join
(``append_results.py``).  Here each grid point runs in-process through the
single-run CLI with the whole replica batch on the device, and the
flock-protected aggregation (``io/aggregate.py``) is kept so that several
sweep processes or hosts can fan into one results.csv.

The grid, the job names, ``parameters.json`` and the CLI's arguments are
the JAX package's; the one addition is ``device`` (default ``cuda``),
passed to each grid point as ``--device``.  It is an argument of
``run_experiments``, not a field of ``SweepParams``, so ``parameters.json``
holds the same keys as the JAX sweep's.  Without a card the sweep stops
before it writes anything, unless ``device="cpu"`` asks for the CPU.

    python -m flowstate_tpu_torch.experiments.sweep --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from flowstate_tpu_torch.experiments import single_run
from flowstate_tpu_torch.io.aggregate import append_results


@dataclass
class SweepParams:
    """Grid definition; reference ``run_experiment_local.py:118-145``."""

    num_particles: int = 3
    density_start: float = 0.03
    density_end: float = 0.03
    density_intervals: int = 1
    temp_start: float = 1.0
    temp_end: float = 1.0
    temp_intervals: int = 1
    aspect_ratio_start: float = 1.0
    aspect_ratio_end: float = 1.0
    aspect_ratio_intervals: int = 1
    equilibration_steps: int = 5000
    production_steps: int = 150000
    sampling_frequency: int = 150
    adjusting_frequency: int = 5000
    output_path: str = "sweep_results"
    experiment_id: str = "sweep"
    num_wells: int = 2
    V0_list: Sequence[float] = field(default_factory=lambda: [-10.0, -10.0])
    k: float = 15.0
    r0: float = 1.2
    initialisation_type: str = "left_half"
    seed: int = 42
    initial_max_displacement: float = 0.65
    num_chains: int = 64


def _grid(start: float, end: float, intervals: int) -> np.ndarray:
    if intervals <= 1:
        return np.array([start])
    return np.linspace(start, end, intervals)


def run_experiments(params: SweepParams, device: str = "cuda") -> str:
    """Run the sweep on ``device``; returns the path of the aggregated
    results.csv."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but torch finds no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    experiment_dir = os.path.join(params.output_path, params.experiment_id)
    os.makedirs(experiment_dir, exist_ok=True)
    with open(os.path.join(experiment_dir, "parameters.json"), "w") as f:
        json.dump({k: (list(v) if isinstance(v, (list, tuple)) else v)
                   for k, v in params.__dict__.items()}, f, indent=4)
    results_csv = os.path.join(experiment_dir, "results.csv")

    for rho in _grid(params.density_start, params.density_end,
                     params.density_intervals):
        for temp in _grid(params.temp_start, params.temp_end,
                          params.temp_intervals):
            for ar in _grid(params.aspect_ratio_start,
                            params.aspect_ratio_end,
                            params.aspect_ratio_intervals):
                job_name = f"rho_{rho:.4f}_T_{temp:.3f}_AR_{ar:.2f}"
                job_dir = os.path.join(experiment_dir, job_name)
                argv = [
                    "--temperature", str(temp),
                    "--num_particles", str(params.num_particles),
                    "--initial_rho", str(rho),
                    "--aspect_ratio", str(ar),
                    "--equilibration_steps", str(params.equilibration_steps),
                    "--production_steps", str(params.production_steps),
                    "--sampling_frequency", str(params.sampling_frequency),
                    "--adjusting_frequency", str(params.adjusting_frequency),
                    "--output_path", experiment_dir,
                    "--experiment_id", job_name,
                    "--num_wells", str(params.num_wells),
                    "--V0_list", *[str(v) for v in params.V0_list],
                    "--k", str(params.k),
                    "--r0", str(params.r0),
                    "--initialisation_type", params.initialisation_type,
                    "--seed", str(params.seed),
                    "--initial_max_displacement",
                    str(params.initial_max_displacement),
                    "--num_chains", str(params.num_chains),
                    "--device", device,
                ]
                single_run.main(argv)
                append_results(results_csv, job_dir, temp,
                               params.equilibration_steps)
    return results_csv


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Run the default sweep (SweepParams())")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the chains (cuda or cpu)")
    return run_experiments(SweepParams(), device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
