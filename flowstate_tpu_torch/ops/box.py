"""Periodic simulation box: PBC wrap and minimum image on tensors.

Port of ``flowstate_tpu/ops/box.py``.  ``Box`` stays a NamedTuple of
floats (static metadata, never a tensor); the functions act on tensors of
any leading shape ending in a (x, y) axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Box(NamedTuple):
    """A rectangular 2D periodic box; ``volume`` is the area."""

    size_x: float
    size_y: float

    @property
    def volume(self) -> float:
        return self.size_x * self.size_y

    @classmethod
    def from_density(cls, num_particles: int, rho: float,
                     aspect_ratio: float = 1.0) -> "Box":
        """``area = N / rho``; ``Lx = sqrt(area * AR)``; ``Ly = sqrt(area / AR)``."""
        area = num_particles / rho
        return cls(float(np.sqrt(area * aspect_ratio)),
                   float(np.sqrt(area / aspect_ratio)))

    def sizes(self, like: torch.Tensor) -> torch.Tensor:
        """(Lx, Ly) as a tensor of ``like``'s dtype and device."""
        return torch.tensor([self.size_x, self.size_y], dtype=like.dtype,
                            device=like.device)


def wrap_pbc(positions: torch.Tensor, box: Box) -> torch.Tensor:
    """Wrap (..., 2) positions into [0, L) per dimension (``jnp.mod``)."""
    return torch.remainder(positions, box.sizes(positions))


def squared_norm(d: torch.Tensor) -> torch.Tensor:
    """``dx^2 + dy^2`` of (..., 2) vectors, rounded as the JAX package's
    ``jnp.sum(d * d, axis=-1)`` is: XLA fuses it into ``fma(dy, dy, dx*dx)``.
    The float64 product is exact, so one rounding to ``d.dtype`` remains."""
    dx, dy = d[..., 0], d[..., 1]
    return (dy.double() * dy.double() + (dx * dx).double()).to(d.dtype)


def min_image(delta: torch.Tensor, box: Box) -> torch.Tensor:
    """Minimum-image (..., 2) displacement: ``delta - L * round(delta / L)``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so a
    displacement of exactly L/2 maps to the same image in both packages.
    """
    sizes = box.sizes(delta)
    return delta - sizes * torch.round(delta / sizes)
