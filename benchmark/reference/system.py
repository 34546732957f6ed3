"""The reference system's energy: a truncated and shifted Lennard-Jones
pair potential (sigma = epsilon = 1, cut at 2.5, shifted to 0 there), a
hard core (any pair closer than 0.5 gives an infinite energy) and the
tanh flat-bottom double well, in a square periodic box of side
sqrt(N / rho), all with the minimum image (round half to even).

Each well i at (L/4, L/2) and (3L/4, L/2) adds
``V0_i (1 - (1 + tanh(k (r_i - r0))) / 2)`` per particle.  The virial
sums ``48 (sr12 - sr6 / 2)`` over the pairs inside the cutoff.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

CUTOFF = 2.5
HARD_CORE = 0.5


@dataclasses.dataclass(frozen=True)
class System:
    n: int
    rho: float
    v0: Tuple[float, float]
    r0: float
    k: float
    beta: float

    @classmethod
    def from_config(cls, system: dict) -> "System":
        return cls(int(system["num_particles"]), float(system["rho"]),
                   tuple(float(v) for v in system["V0_list"]),
                   float(system["r0"]), float(system["k_val"]),
                   1.0 / float(system["temperature"]))

    @property
    def box(self) -> float:
        return math.sqrt(self.n / self.rho)

    @property
    def half_box(self) -> float:
        return self.box / 2.0

    def centers(self):
        box = self.box
        return ((box / 4.0, box / 2.0), (3.0 * box / 4.0, box / 2.0))


def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    return d - box * torch.round(d / box)


def lj(r2: torch.Tensor):
    """Energy and virial of pairs at squared distance ``r2`` (0 beyond the
    cutoff)."""
    sr2 = 1.0 / torch.clamp(r2, min=1e-24)
    sr6 = sr2 ** 3
    src = (1.0 / CUTOFF ** 2) ** 3
    inside = r2 <= CUTOFF ** 2
    e = 4.0 * (sr6 * sr6 - sr6) - 4.0 * (src * src - src)
    w = 48.0 * (sr6 * sr6 - 0.5 * sr6)
    zero = torch.zeros_like(e)
    return torch.where(inside, e, zero), torch.where(inside, w, zero)


def well_energy(sys: System, p: torch.Tensor) -> torch.Tensor:
    """The wells' energy of (..., 2) positions."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for (cx, cy), v0 in zip(sys.centers(), sys.v0):
        dx = min_image(p[..., 0] - cx, sys.box)
        dy = min_image(p[..., 1] - cy, sys.box)
        r = torch.sqrt(dx * dx + dy * dy)
        total = total + v0 * (1.0 - 0.5 * (1.0 + torch.tanh(sys.k * (r - sys.r0))))
    return total


def energy_virial(sys: System, positions: torch.Tensor):
    """(energy, virial) of each configuration of a (B, N, 2) batch, in the
    batch's dtype; an overlap gives (inf, inf)."""
    d = min_image(positions[:, :, None, :] - positions[:, None, :, :], sys.box)
    r2 = (d * d).sum(-1)
    i, j = torch.triu_indices(sys.n, sys.n, offset=1, device=positions.device)
    r2 = r2[:, i, j]
    e, w = lj(r2)
    energy = e.sum(-1) + well_energy(sys, positions).sum(-1)
    virial = w.sum(-1)
    overlap = (r2 < HARD_CORE ** 2).any(-1)
    inf = torch.full_like(energy, math.inf)
    return torch.where(overlap, inf, energy), torch.where(overlap, inf, virial)
