"""Unified experiment configuration.

Port of ``flowstate_tpu/utils/config.py``, unchanged: the same fields and
presets, so both packages write the same ``params.json``.

One dataclass covering every knob of the reference's three config styles
(SURVEY.md §5): the hybrid drivers' module-level constants
(``main_algorithm_1.py:32-73``, ``main_algorithm_2.py:32-76``,
``main_mcmc_only.py:32-59``), the argparse flags of ``MCMC/main.py:16-50``,
and the NPZ trainer CLI.  Serialized to ``params.json`` for provenance like
the reference (``main_algorithm_1.py:94-134``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass
class ExperimentConfig:
    # ensemble
    num_chains: int = 10              # NUM_MC_RUNS
    master_seed: int = 42
    num_particles: int = 3
    num_dim: int = 2

    # thermodynamic state
    temperature: float = 1.0
    rho: float = 0.03
    aspect_ratio: float = 1.0

    # external wells
    num_wells: int = 2
    V0_list: Tuple[float, ...] = (-10.0, -10.5)
    r0: float = 1.2
    k_val: float = 15.0

    # MC schedule
    equilibration_steps: int = 5000
    initial_max_displacement: float = 0.65
    sampling_frequency: int = 150
    adjusting_frequency: int = 5000
    target_acceptance: float = 0.5
    # production move kernel: "metropolis" or the gradient samplers
    # "mala" / "hmc" (mcmc/mala.py, mcmc/hmc.py).  HMC trajectories are
    # budgeted in gradient evaluations: sampling_frequency/num_leapfrog
    # trajectories per sample block
    sampler: str = "metropolis"
    num_leapfrog: int = 10

    # parallel tempering (sampler="pt"; flowstate_tpu/mcmc/tempering.py)
    pt_replicas: int = 10
    pt_t_hot: float = 10.0
    pt_moves_per_round: int = 150     # local moves between exchange sweeps
    pt_ladder: str = "geometric"
    pt_segment_rounds: int = 200      # rounds per segment (the
    #                                   checkpoint/resume granularity)

    # flow architecture
    K: int = 15
    hidden_units: int = 256
    num_bins: int = 32
    n_blocks: int = 2
    net_type: str = "residual"

    # training
    initial_training_num_samples: int = 102400
    batch_size: int = 512
    epochs: int = 100
    lr: float = 1e-4
    weight_decay: float = 0.0
    alpha: float = 1.0
    num_training_cycles: int = 0
    update_num_samples: int = 0
    cumulative_training_samples: bool = True
    checkpoint_interval: int = 25

    # hybrid testing schedule
    testing: bool = True
    big_move_attempts: int = 1000
    big_move_interval: int = 1000
    # blocked conditional proposals (flowstate_tpu_torch/mcmc/blocked.py):
    # 0 = global big moves (the reference schedule); k > 0 = resample k
    # particles per move from a flow conditioned on the other N-k
    blocked_k: int = 0
    blocked_context_modes: int = 3   # Fourier context m_max
    # depth of the conditional flow (the global ``K`` is a separate knob)
    blocked_K: int = 6
    # fuse the whole testing phase into one device program (None = auto;
    # flowstate_tpu/experiments/algorithm1.py)
    fused_testing: "bool | None" = None

    # analysis
    num_samples_for_analysis: int = 50000
    num_samples_for_free_energy: int = 5000

    # io
    output_dir: str = "results"
    experiment_id: str = "exp"

    @property
    def half_box(self) -> float:
        """HALF_BOX = ((N/rho)^(1/d))/2; reference main_algorithm_1.py:50.

        Like the reference constant, this assumes a SQUARE box; the hybrid
        drivers therefore reject aspect_ratio != 1 (the flow's torus frame
        would not match the simulation box).
        """
        if abs(self.aspect_ratio - 1.0) > 1e-12:
            raise ValueError(
                "half_box (the flow's torus bound) assumes aspect_ratio=1; "
                "non-square boxes are only supported by the plain-MCMC "
                "drivers (single_run/sweep)")
        return ((self.num_particles / self.rho) ** (1.0 / self.num_dim)) / 2.0

    @property
    def dim(self) -> int:
        return self.num_particles * self.num_dim

    @property
    def beta(self) -> float:
        return 1.0 / self.temperature

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["HALF_BOX"] = self.half_box
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            d = json.load(f)
        d.pop("HALF_BOX", None)
        if "V0_list" in d:
            d["V0_list"] = tuple(d["V0_list"])
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


# Reference full-scale presets -------------------------------------------

def algorithm1_config(**overrides) -> ExperimentConfig:
    """Full-scale Algorithm 1 preset (main_algorithm_1.py:32-73)."""
    cfg = ExperimentConfig(num_chains=10, K=15, hidden_units=256,
                           num_bins=32, epochs=100, lr=1e-4,
                           initial_training_num_samples=102400,
                           batch_size=512, num_training_cycles=0,
                           big_move_attempts=1000, big_move_interval=1000,
                           cumulative_training_samples=True)
    return dataclasses.replace(cfg, **overrides)


def algorithm2_config(**overrides) -> ExperimentConfig:
    """Full-scale Algorithm 2 preset (main_algorithm_2.py:32-76)."""
    cfg = ExperimentConfig(num_chains=100, K=23, hidden_units=128,
                           num_bins=15, n_blocks=2, epochs=1,
                           lr=0.000543510751759681,
                           weight_decay=9.5857178422352e-05,
                           initial_training_num_samples=1000,
                           batch_size=256, num_training_cycles=1000,
                           update_num_samples=1000,
                           sampling_frequency=10, adjusting_frequency=10000,
                           cumulative_training_samples=False,
                           checkpoint_interval=10, alpha=1.0)
    return dataclasses.replace(cfg, **overrides)


def mcmc_only_config(**overrides) -> ExperimentConfig:
    """Baseline MCMC preset (main_mcmc_only.py:32-59)."""
    cfg = ExperimentConfig(num_chains=100, num_training_cycles=0,
                           testing=False, big_move_attempts=0)
    return dataclasses.replace(cfg, **overrides)


def tempering_config(**overrides) -> ExperimentConfig:
    """Parallel-tempering production preset (driver shape of
    main_mcmc_only.py:33-59; the ladder defaults reproduce the
    TEMPERING.md cross-check and the hybrid_n_scaling PT oracle)."""
    cfg = ExperimentConfig(num_chains=50, sampler="pt",
                           num_training_cycles=0, testing=False,
                           big_move_attempts=0)
    return dataclasses.replace(cfg, **overrides)
