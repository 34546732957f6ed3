"""Shared experiment plumbing: setup, equilibration, artifact dumps.

Port of ``flowstate_tpu/experiments/common.py``, less the JAX compilation
cache.  Equilibration runs its move segments through
``cuda_metropolis.run_moves_auto``: on the card, the move kernel.
"""

from __future__ import annotations

import csv
import datetime
import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import plot_potential
from flowstate_tpu_torch.analysis.wells import classify_particles
from flowstate_tpu_torch.flows import build_conditional_circular_flow
from flowstate_tpu_torch.mcmc.blocked import (
    fourier_context, fourier_context_dim,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import ChainState, init_chain_state
from flowstate_tpu_torch.ops import Box, SystemSpec
from flowstate_tpu_torch.utils.config import ExperimentConfig
from flowstate_tpu_torch.utils.logging import MetricsWriter, setup_logger


def build_system(config: ExperimentConfig) -> SystemSpec:
    box = Box.from_density(config.num_particles, config.rho,
                           config.aspect_ratio)
    return SystemSpec.create(
        config.num_particles, box, num_wells=config.num_wells,
        V0_list=config.V0_list, r0=config.r0, k=config.k_val)


def setup_experiment(config: ExperimentConfig
                     ) -> Tuple[str, logging.Logger, MetricsWriter]:
    """Create the experiment directory tree, ``experiment.log``,
    ``params.json`` and the ``metrics.jsonl`` stream."""
    directory = os.path.join(config.output_dir, config.experiment_id)
    os.makedirs(directory, exist_ok=True)
    os.makedirs(os.path.join(directory, "mc_runs"), exist_ok=True)
    os.makedirs(os.path.join(directory, "training_rounds"), exist_ok=True)
    logger = setup_logger("experiment",
                          os.path.join(directory, "experiment.log"),
                          stream_level=logging.INFO)
    config.save(os.path.join(directory, "params.json"))
    metrics = MetricsWriter(os.path.join(directory, "metrics.jsonl"))
    logger.info("half box is: %s", config.half_box)
    logger.info("Directory created at: %s", directory)
    return directory, logger, metrics


def init_and_equilibrate(config: ExperimentConfig, spec: SystemSpec,
                         device, logger: Optional[logging.Logger] = None
                         ) -> ChainState:
    """Alternating-well init on ``device`` and adaptive equilibration."""
    positions, _ = init_alternating_wells(
        config.num_chains, config.num_particles, config.rho,
        config.aspect_ratio)
    state = init_chain_state(
        spec, torch.as_tensor(positions, dtype=torch.float32, device=device),
        config.master_seed, config.initial_max_displacement)
    if logger:
        logger.info("All %d chains initialised (alternating wells) on %s",
                    config.num_chains, state.device)
    state = run_equilibration(
        spec, config.beta, state, config.equilibration_steps,
        config.adjusting_frequency, config.target_acceptance,
        move_fn=lambda s, n: run_moves_auto(spec, config.beta, s, n))
    if logger:
        logger.info("Equilibration done: %d steps/chain",
                    config.equilibration_steps)
    return state


def build_blocked_flow(config: ExperimentConfig,
                       generator: Optional[torch.Generator], device):
    """The blocked moves' conditional flow of ``config`` (a block of
    ``blocked_k`` particles, depth ``blocked_K``, the global flow's
    widths) and its context, the Fourier modes up to
    ``blocked_context_modes``: ``(model, context_fn)``."""
    m_max = config.blocked_context_modes
    model = build_conditional_circular_flow(
        config.blocked_k, config.num_dim, config.half_box,
        context_features=fourier_context_dim(m_max), K=config.blocked_K,
        hidden_units=config.hidden_units, num_bins=config.num_bins,
        num_blocks=config.n_blocks, generator=generator, device=device)

    def context_fn(rest: torch.Tensor, positions: torch.Tensor):
        return fourier_context(rest, positions, config.half_box, m_max)

    return model, context_fn


def log_blocked_depth(config: ExperimentConfig, logger) -> None:
    """Log the conditional flow's depth and net that take effect: the JAX
    drivers build it at ``blocked_K`` with a residual net whatever ``K``
    and ``net_type`` say (ROADMAP R3, R11)."""
    logger.info("conditional flow K=blocked_K=%d; K=%d unused",
                config.blocked_K, config.K)
    if config.net_type != "residual":
        logger.info("conditional flow net: residual; net_type=%s unused",
                    config.net_type)


def plot_wells(config: ExperimentConfig, spec: SystemSpec,
               directory: str) -> Optional[Tuple[str, str]]:
    """The potential figure; None without matplotlib."""
    return plot_potential(spec.box.size_x, spec.box.size_y,
                          list(config.V0_list), config.r0, config.k_val,
                          config.num_wells, directory)


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _thin(seq, max_points: int = 2000) -> list:
    """A long series subsampled to <= max_points, first and last kept."""
    arr = np.asarray(seq, dtype=float)
    if arr.size <= max_points:
        return arr.tolist()
    idx = np.unique(np.round(
        np.linspace(0, arr.size - 1, max_points)).astype(int))
    return arr[idx].tolist()


def write_evidence(config: ExperimentConfig, payload: dict, device,
                   evidence_dir: Optional[str] = None) -> str:
    """Commit-sized per-run summary JSON, under
    ``<output_dir>/evidence/<experiment_id>_data.json`` by default."""
    if evidence_dir is None:
        evidence_dir = os.path.join(config.output_dir, "evidence")
    os.makedirs(evidence_dir, exist_ok=True)
    doc = {
        "experiment_id": config.experiment_id,
        "written_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "device": device_name(device),
        "config": config.to_dict(),
        **payload,
    }
    path = os.path.join(evidence_dir, f"{config.experiment_id}_data.json")

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=default)
    return path


def sector_counts(configs: np.ndarray, half_box: float, r0: float = 1.2,
                  burn_frac: float = 0.5) -> dict:
    """Sector occupancy of a (C, T, N, 2) trajectory stack after discarding
    the first ``burn_frac`` of every chain: ``kB`` counts fully-in-well
    configurations with k particles in well B, ``outside`` those with any
    particle in neither well."""
    t = configs.shape[1]
    post = configs[:, int(t * burn_frac):]
    lab = classify_particles(post, half_box, r0)          # (C, T', N)
    n_b = (lab == 1).sum(axis=-1)
    any_out = (lab == 2).any(axis=-1)
    n = configs.shape[2]
    sec = np.where(any_out, n + 1, n_b)
    counts = {f"{k}B": int((sec == k).sum()) for k in range(n + 1)}
    counts["outside"] = int((sec == n + 1).sum())
    counts["burn_frac"] = burn_frac
    return counts


def dump_run_artifacts(directory: str, run_idx: int,
                       observables, testing_configs: Optional[np.ndarray]
                       ) -> None:
    """Per-run ``sampled_data.csv`` and ``mc_run_configs.npy`` from one
    chain's host observables (leaves (T, ...))."""
    run_dir = os.path.join(directory, "mc_runs", f"run_{run_idx + 1:03d}")
    os.makedirs(run_dir, exist_ok=True)

    csv_path = os.path.join(run_dir, "sampled_data.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["cycle_number", "energy_per_particle", "density",
                         "pressure", "box_size_x", "box_size_y",
                         "particle_configuration"])
        for i in range(len(observables.cycle)):
            writer.writerow([
                int(observables.cycle[i]),
                float(observables.energy_per_particle[i]),
                float(observables.density[i]),
                float(observables.pressure[i]),
                float(observables.box_size_x[i]),
                float(observables.box_size_y[i]),
                np.asarray(observables.positions[i]).flatten().tolist(),
            ])

    np.save(os.path.join(run_dir, "mc_run_configs.npy"),
            np.asarray(observables.positions))
    if testing_configs is not None:
        np.save(os.path.join(run_dir, "mc_run_testing_configs.npy"),
                np.asarray(testing_configs))
