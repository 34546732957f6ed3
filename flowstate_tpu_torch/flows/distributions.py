"""Base distribution of the circular flow.

Port of ``flowstate_tpu/flows/distributions.py::UniformParticle`` (:31):
uniform on the torus ``[-bound, bound]^(n_particles * n_dim)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class UniformParticle:
    """``log_prob`` is ``-D log(2 bound)`` inside the bounds and ``-inf``
    outside; ``sample`` draws float32 from an explicit generator."""

    n_particles: int
    n_dim: int
    bound: float

    @property
    def dim(self) -> int:
        return self.n_particles * self.n_dim

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        u = torch.rand((num_samples, self.dim), generator=generator,
                       dtype=torch.float32, device=device)
        return -self.bound + (2.0 * self.bound) * u

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        in_bounds = torch.all((z >= -self.bound) & (z <= self.bound), dim=-1)
        const = -self.dim * math.log(2.0 * self.bound)
        return torch.where(in_bounds, torch.full_like(z[:, 0], const),
                           torch.full_like(z[:, 0], -math.inf))
