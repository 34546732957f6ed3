"""Equilibration check and ensemble acceptance.

Port of ``flowstate_tpu/mcmc/observables.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flowstate_tpu_torch.mcmc.state import ChainState


def check_equilibration(pressure_history: np.ndarray,
                        density_history: np.ndarray,
                        tolerance: float = 0.05,
                        window: int = 500) -> bool:
    """Relative-std steadiness of the last ``window`` pressures and
    densities."""
    if len(pressure_history) < window:
        return False
    p = np.asarray(pressure_history[-window:])
    d = np.asarray(density_history[-window:])
    conds = []
    for arr in (p, d):
        mean = arr.mean()
        conds.append(bool(arr.std() / mean < tolerance) if mean != 0 else False)
    return all(conds)


def acceptance_fraction(state: ChainState) -> torch.Tensor:
    """Per-chain acceptance ratio over the whole run."""
    att = torch.clamp(state.attempts, min=1)
    return state.accepts / att.to(torch.float32)


def ensemble_acceptance(state: ChainState) -> Tuple[int, int]:
    """(total accepted, total attempted) across the chain batch."""
    return int(torch.sum(state.accepts)), int(torch.sum(state.attempts))
