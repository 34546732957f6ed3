"""System energies on a batch of configurations.

Port of ``flowstate_tpu/ops/pair_energy.py``.  The JAX functions take one
(N, 2) configuration and are vmapped over chains; here every function
takes a (C, N, 2) batch.  A hard-core overlap (any pair closer than
``spec.hard_core``) gives ``(+inf, +inf)``, so the Metropolis rule rejects
it: ``exp(-beta * inf) == 0``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from flowstate_tpu_torch.ops.box import Box, min_image, squared_norm
from flowstate_tpu_torch.ops.potentials import (
    HARD_CORE_RADIUS,
    double_well_potential,
    lennard_jones_energy_virial,
)


class SystemSpec(NamedTuple):
    """Static description of the interacting system (never a tensor)."""

    num_particles: int
    box: Box
    num_wells: int = 0
    V0_list: Tuple[float, ...] = (-4.0, -4.2)
    r0: float = 1.0
    k: float = 10.0
    epsilon: float = 1.0
    sigma: float = 1.0
    cutoff: float = 2.5
    hard_core: float = HARD_CORE_RADIUS

    @classmethod
    def create(cls, num_particles: int, box: Box, num_wells: int = 0,
               V0_list: Sequence[float] = (-4.0, -4.2), r0: float = 1.0,
               k: float = 10.0, **kw) -> "SystemSpec":
        return cls(num_particles=num_particles, box=box, num_wells=num_wells,
                   V0_list=tuple(float(v) for v in V0_list), r0=float(r0),
                   k=float(k), **kw)


def _well_energy(spec: SystemSpec, positions: torch.Tensor) -> torch.Tensor:
    """External energy of each (..., 2) position (0 without wells)."""
    if spec.num_wells == 0:
        return torch.zeros(positions.shape[:-1], dtype=positions.dtype,
                           device=positions.device)
    return double_well_potential(
        positions, spec.box.size_x, spec.box.size_y,
        V0_list=list(spec.V0_list), r0=spec.r0, k=spec.k,
        num_wells=spec.num_wells)


def _external_energy(spec: SystemSpec, positions: torch.Tensor) -> torch.Tensor:
    """Sum of the external well energies over particles: (C, N, 2) -> (C,)."""
    return torch.sum(_well_energy(spec, positions), dim=-1)


def _lj(spec: SystemSpec, r: torch.Tensor):
    return lennard_jones_energy_virial(
        r, epsilon=spec.epsilon, sigma=spec.sigma,
        cutoff_constant=spec.cutoff, shift=True)


def total_energy_virial(spec: SystemSpec, positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total energy and virial of each (N, 2) configuration of a (C, N, 2)
    batch: LJ over unique pairs plus the wells; (C,) each."""
    n = spec.num_particles
    diff = min_image(positions[:, :, None, :] - positions[:, None, :, :],
                     spec.box)
    sq = squared_norm(diff)                              # (C, N, N)
    iu, ju = torch.triu_indices(n, n, offset=1, device=positions.device)
    r = torch.sqrt(torch.clamp(sq[:, iu, ju], min=1e-24))
    e_pair, w_pair = _lj(spec, r)
    energy = torch.sum(e_pair, dim=-1) + _external_energy(spec, positions)
    virial = torch.sum(w_pair, dim=-1)
    overlap = torch.any(r < spec.hard_core, dim=-1)
    inf = torch.full_like(energy, float("inf"))
    return torch.where(overlap, inf, energy), torch.where(overlap, inf, virial)


def particle_energy_virial(spec: SystemSpec, positions: torch.Tensor,
                           idx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy and virial of particle ``idx[c]`` of each chain against all
    others, plus its external energy; (C,) each."""
    c, n = positions.shape[0], positions.shape[1]
    idx = idx.long()
    p = positions[torch.arange(c, device=positions.device), idx]   # (C, 2)
    diff = min_image(p[:, None, :] - positions, spec.box)
    sq = squared_norm(diff)                              # (C, N)
    self_mask = torch.arange(n, device=positions.device)[None, :] == idx[:, None]
    r = torch.sqrt(torch.clamp(sq, min=1e-24))
    e_pair, w_pair = _lj(spec, r)
    zero = torch.zeros_like(e_pair)
    energy = torch.sum(torch.where(self_mask, zero, e_pair), dim=-1)
    virial = torch.sum(torch.where(self_mask, zero, w_pair), dim=-1)
    if spec.num_wells > 0:
        energy = energy + _well_energy(spec, p)
    overlap = torch.any(~self_mask & (r < spec.hard_core), dim=-1)
    inf = torch.full_like(energy, float("inf"))
    return torch.where(overlap, inf, energy), torch.where(overlap, inf, virial)


def pressure(spec: SystemSpec, virial: torch.Tensor, beta: float) -> torch.Tensor:
    """NVT virial pressure ``rho / beta + W / (2 V)``."""
    volume = spec.box.volume
    return spec.num_particles / volume / beta + virial / (2.0 * volume)
