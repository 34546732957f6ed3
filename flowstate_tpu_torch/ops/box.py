"""Periodic simulation box: PBC wrap and minimum image on tensors.

Port of ``flowstate_tpu/ops/box.py``.  ``Box`` stays a NamedTuple of
floats (static metadata, never a tensor); the functions act on tensors of
any leading shape ending in a (x, y) axis.  Distances take
``squared_norm``'s rounding, as the JAX package's ``jnp.sum(d * d, -1)``
has it.
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


def min_image_centered(delta: torch.Tensor, half_box: float) -> torch.Tensor:
    """Minimum image in the flow's centred frame [-half_box, half_box]^d:
    ``delta - 2 b round(delta / 2 b)``."""
    period = 2.0 * half_box
    return delta - period * torch.round(delta / period)


def distance(p1: torch.Tensor, p2: torch.Tensor, box: Box) -> torch.Tensor:
    """Minimum-image distance between two (..., 2) position tensors."""
    return torch.sqrt(squared_norm(min_image(p1 - p2, box)))


def distances_to_all(p: torch.Tensor, others: torch.Tensor,
                     box: Box) -> torch.Tensor:
    """Distances from one position (2,) to each of (M, 2)."""
    return torch.sqrt(squared_norm(min_image(p[None, :] - others, box)))


def pair_distance_matrix(positions: torch.Tensor, box: Box) -> torch.Tensor:
    """The (N, N) minimum-image distance matrix of a (N, 2) configuration,
    0 on the diagonal, whose sqrt is guarded so that autograd gives the
    diagonal a zero gradient."""
    sq = squared_norm(min_image(positions[:, None, :] - positions[None, :, :],
                                box))
    eye = torch.eye(positions.shape[0], dtype=torch.bool,
                    device=positions.device)
    safe = torch.where(eye, torch.ones_like(sq), sq)
    return torch.where(eye, torch.zeros_like(sq), torch.sqrt(safe))


def upper_triangle_distances(positions: torch.Tensor,
                             box: Box) -> torch.Tensor:
    """The N (N - 1) / 2 pair distances of a (N, 2) configuration, i < j
    in row order."""
    iu, ju = np.triu_indices(positions.shape[0], k=1)
    iu = torch.as_tensor(iu, device=positions.device)
    ju = torch.as_tensor(ju, device=positions.device)
    return torch.sqrt(squared_norm(min_image(positions[iu] - positions[ju],
                                             box)))
