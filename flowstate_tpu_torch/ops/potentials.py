"""Pair and external potentials on tensors.

Port of ``flowstate_tpu/ops/potentials.py``: the truncated-shifted
Lennard-Jones energy and virial, the tanh flat-bottom double well, and the
two 2D tail corrections.  Branchless (``torch.where`` masks), any leading
shape.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from flowstate_tpu_torch.ops.box import squared_norm

# Pair distances below this are a hard-core overlap (energy +inf).
HARD_CORE_RADIUS = 0.5


def lennard_jones_energy_virial(
    r: torch.Tensor,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    cutoff_constant: float = 2.5,
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For r <= r_cut: ``e = 4 eps (sr12 - sr6) [- e(r_cut)]`` and
    ``w = 48 eps (sr12 - 0.5 sr6)``; both 0 beyond the cutoff."""
    r_cut = cutoff_constant  # sigma = 1 convention, as in the JAX package
    mask = r <= r_cut
    r_safe = torch.clamp(r, min=1e-12)
    # (s/r)^6 as s2 * (s2 * s2): the product order of jax.lax.integer_pow,
    # so that the port rounds as the JAX package does (** 6 does not)
    sr2 = (sigma / r_safe) * (sigma / r_safe)
    sr6 = sr2 * (sr2 * sr2)
    sr12 = sr6 * sr6
    energy = 4.0 * epsilon * (sr12 - sr6)
    virial = 48.0 * epsilon * (sr12 - 0.5 * sr6)
    if shift:
        sr6_cut = (sigma / r_cut) ** 6
        energy = energy - 4.0 * epsilon * (sr6_cut * sr6_cut - sr6_cut)
    zero = torch.zeros_like(energy)
    return torch.where(mask, energy, zero), torch.where(mask, virial, zero)


def tail_correction_energy_2d(rho: float, num_particles: int, r_cut: float,
                              epsilon: float = 1.0,
                              sigma: float = 1.0) -> float:
    """2D LJ energy tail correction."""
    return (8.0 * math.pi * epsilon * rho * num_particles) * (
        sigma**12 / (10.0 * r_cut**10) - sigma**6 / (4.0 * r_cut**4))


def tail_correction_pressure_2d(rho: float, r_cut: float,
                                epsilon: float = 1.0,
                                sigma: float = 1.0) -> float:
    """2D LJ pressure tail correction."""
    return (24.0 * math.pi * epsilon * rho**2) * (
        sigma**12 / (5.0 * r_cut**10) - sigma**6 / (4.0 * r_cut**4))


def well_centers(box_size_x: float, box_size_y: float,
                 num_wells: int) -> list:
    """Well centers (Lx/4, Ly/2) and (3Lx/4, Ly/2), the first ``num_wells``."""
    return [(box_size_x / 4.0, box_size_y / 2.0),
            (3.0 * box_size_x / 4.0, box_size_y / 2.0)][:num_wells]


def double_well_potential(
    position: torch.Tensor,
    box_size_x: float,
    box_size_y: float,
    V0_list: Sequence[float] | None = None,
    r0: float = 1.0,
    k: float = 10.0,
    num_wells: int = 2,
) -> torch.Tensor:
    """Tanh flat-bottom multi-well potential of (..., 2) positions.

    Per well: ``V0_i * (1 - 0.5 (1 + tanh(k (r_i - r0))))`` with the
    min-image displacement to the well center.  Returns
    ``position.shape[:-1]``.
    """
    if V0_list is None:
        V0_list = [-4.0] * num_wells
    centers = torch.tensor(well_centers(box_size_x, box_size_y, num_wells),
                           dtype=position.dtype, device=position.device)
    sizes = torch.tensor([box_size_x, box_size_y], dtype=position.dtype,
                         device=position.device)
    v0 = torch.tensor(list(V0_list)[:num_wells], dtype=position.dtype,
                      device=position.device)
    d = position[..., None, :] - centers                 # (..., W, 2)
    d = d - sizes * torch.round(d / sizes)
    r = torch.sqrt(squared_norm(d))                      # (..., W)
    transition = 0.5 * (1.0 + torch.tanh(k * (r - r0)))
    return torch.sum(v0 * (1.0 - transition), dim=-1)
