"""Pair and external potentials on tensors.

Port of ``flowstate_tpu/ops/potentials.py``: the truncated-shifted
Lennard-Jones energy and virial and its pair force, the tanh flat-bottom
double well with its equal-depth form, the Gaussian double well, and the
two 2D tail corrections.  Branchless (``torch.where`` masks), any leading
shape.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from flowstate_tpu_torch.ops.box import squared_norm

# The hybrid experiments' default well depths.
DEFAULT_V0_LIST = (-4.0, -4.0)

# Pair distances below this are a hard-core overlap (energy +inf).
HARD_CORE_RADIUS = 0.5


def _sr6(sigma: float, r_safe: torch.Tensor) -> torch.Tensor:
    # (s/r)^6 as s2 * (s2 * s2): the product order of jax.lax.integer_pow,
    # so that the port rounds as the JAX package does (** 6 does not)
    sr2 = (sigma / r_safe) * (sigma / r_safe)
    return sr2 * (sr2 * sr2)


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
    sr6 = _sr6(sigma, r_safe)
    sr12 = sr6 * sr6
    energy = 4.0 * epsilon * (sr12 - sr6)
    virial = 48.0 * epsilon * (sr12 - 0.5 * sr6)
    if shift:
        sr6_cut = (sigma / r_cut) ** 6
        energy = energy - 4.0 * epsilon * (sr6_cut * sr6_cut - sr6_cut)
    zero = torch.zeros_like(energy)
    return torch.where(mask, energy, zero), torch.where(mask, virial, zero)


def lennard_jones_force(
    r: torch.Tensor,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    cutoff_constant: float = 2.5,
) -> torch.Tensor:
    """The LJ pair force's magnitude ``24 eps (2 sr12 - sr6) / r`` for
    0 < r <= ``cutoff_constant * sigma`` (the energy's cutoff is the bare
    ``cutoff_constant``: the two differ for sigma != 1, as in the JAX
    package), 0 elsewhere."""
    mask = (r > 0) & (r <= cutoff_constant * sigma)
    r_safe = torch.clamp(r, min=1e-12)
    sr6 = _sr6(sigma, r_safe)
    force = 24.0 * epsilon * (2.0 * (sr6 * sr6) - sr6) / r_safe
    return torch.where(mask, force, torch.zeros_like(force))


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


def double_well_potential_equal(
    position: torch.Tensor,
    box_size_x: float,
    box_size_y: float,
    V0: float = -2.0,
    r0: float = 1.0,
    k: float = 10.0,
    num_wells: int = 2,
) -> torch.Tensor:
    """The double well with every well at depth ``V0``."""
    return double_well_potential(position, box_size_x, box_size_y,
                                 V0_list=[V0] * num_wells, r0=r0, k=k,
                                 num_wells=num_wells)


def gaussian_double_well(
    position: torch.Tensor,
    box_size_x: float,
    box_size_y: float,
    V0: float = -0.5,
    a: float = 5.0,
    num_wells: int = 2,
) -> torch.Tensor:
    """``sum_i V0 exp(-a r_i^2)`` over the wells, with the minimum-image
    displacement to each center; returns ``position.shape[:-1]``."""
    centers = torch.tensor(well_centers(box_size_x, box_size_y, num_wells),
                           dtype=position.dtype, device=position.device)
    sizes = torch.tensor([box_size_x, box_size_y], dtype=position.dtype,
                         device=position.device)
    d = position[..., None, :] - centers
    d = d - sizes * torch.round(d / sizes)
    return torch.sum(V0 * torch.exp(-a * squared_norm(d)), dim=-1)
