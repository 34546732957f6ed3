"""Energy targets for reverse-KLD training.

Port of ``flowstate_tpu/flows/targets.py``: ``SimpleLJ`` (:31),
``DoubleWellLJ`` (:75), ``DWNormal`` (:100) and ``CoulombGas`` (:122).
Each ``energy(x)`` is a differentiable function of a (B, dim) tensor of
flattened coordinates in the flow's centred frame, computed in ``x``'s
dtype on ``x``'s device.

What the JAX version does is kept: the min-image wrap of the absolute
coordinates ``pos - period * round(pos / period)`` (``torch.round`` and
``jnp.round`` both round half to even), then raw differences
(``SimpleLJ.py:25-27`` of the reference takes them so), ``sqrt(max(sq,
1e-24))``, the linearised hard core below r = 0.82 chosen by a ``where``
over both branches, no cutoff and no shift.  This is not the MCMC
potential of ``ops/potentials.py`` and the pair-energy kernel (truncated,
shifted, +inf on an overlap, no backward); the flow's loss needs this one
and its gradient.

The ``where`` keeps both branches, as JAX does, so the gradients agree:
below r ~ 1e-12 the unused branch's r^-6 overflows and its gradient is
NaN, which the train step's ``nan_to_num`` zeroes in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SimpleLJ:
    """Linearised-hard-core LJ energy on the torus, divided by T.

    ``phantom_origin`` prepends a particle pinned at the origin, as the
    reference's ``SimpleLJ.py:21-23`` does (off by default, as in JAX).
    """

    dim: int
    n_particles: int
    temperature: float
    bound: float
    breakpoint: float = 0.82
    phantom_origin: bool = False

    @property
    def n_dimensions(self) -> int:
        return self.dim // self.n_particles

    def _pair_distances(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        pos = x.reshape(b, self.n_particles, self.n_dimensions)
        period = 2.0 * self.bound
        pos = pos - period * torch.round(pos / period)
        if self.phantom_origin:
            pos = torch.cat([torch.zeros_like(pos[:, :1]), pos], dim=1)
        n = pos.shape[1]
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        sq = torch.sum(diff * diff, dim=-1)
        iu, ju = torch.triu_indices(n, n, 1, device=x.device)
        return torch.sqrt(torch.clamp(sq[:, iu, ju], min=1e-24))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        r = self._pair_distances(x)
        bk = self.breakpoint
        lin = -80.0 * (r - bk) + 30.0
        inv6 = (1.0 / r) ** 6
        lj = 4.0 * (inv6 * inv6 - inv6)
        e = torch.where(r <= bk, lin, lj)
        return torch.sum(e, dim=-1) / self.temperature


@dataclasses.dataclass(frozen=True)
class DoubleWellLJ(SimpleLJ):
    """LJ plus the tanh double well centred at (-bound/2, 0) and
    (+bound/2, 0) in the centred frame (the wells are not divided by T,
    as in JAX and the reference)."""

    V0_list: Tuple[float, float] = (-4.0, -4.0)
    r0: float = 1.0
    k: float = 10.0

    def double_well_potential(self, positions: torch.Tensor) -> torch.Tensor:
        """positions: (B, N, 2) centred coordinates; returns (B,)."""
        L = 2.0 * self.bound
        centers = torch.tensor([[-self.bound / 2.0, 0.0],
                                [self.bound / 2.0, 0.0]],
                               dtype=positions.dtype, device=positions.device)
        v0 = torch.tensor(self.V0_list, dtype=positions.dtype,
                          device=positions.device)
        d = positions[:, :, None, :] - centers            # (B, N, W, 2)
        d = d - L * torch.round(d / L)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        transition = 0.5 * (1.0 + torch.tanh(self.k * (r - self.r0)))
        return torch.sum(v0 * (1.0 - transition), dim=(-1, -2))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        lj = SimpleLJ.energy(self, x)
        pos = x.reshape(x.shape[0], self.n_particles, self.n_dimensions)
        return lj + self.double_well_potential(pos)


@dataclasses.dataclass(frozen=True)
class DWNormal:
    """Per-coordinate double-well normal target:

    energy(x) = sum_i -log(exp(-(x_i - mu)^2 / (2 s^2))
                          + exp(-(x_i + mu)^2 / (2 s^2))) / T
    """

    dim: int
    temperature: float = 1.0
    mu: float = 2.0
    sigma: float = 0.5

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        s2 = 2.0 * self.sigma ** 2
        a = -((x - self.mu) ** 2) / s2
        b = -((x + self.mu) ** 2) / s2
        return torch.sum(-torch.logaddexp(a, b), dim=-1) / self.temperature


@dataclasses.dataclass(frozen=True)
class CoulombGas:
    """2-D Coulomb-gas pair energy, -sum log r / T."""

    dim: int
    n_particles: int
    temperature: float = 1.0

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        pos = x.reshape(b, self.n_particles, self.dim // self.n_particles)
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        sq = torch.sum(diff * diff, dim=-1)
        n = self.n_particles
        iu, ju = torch.triu_indices(n, n, 1, device=x.device)
        r = torch.sqrt(torch.clamp(sq[:, iu, ju], min=1e-24))
        return -torch.sum(torch.log(r), dim=-1) / self.temperature
