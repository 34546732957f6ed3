"""Initial-configuration builders (host-side numpy; not on the hot path).

Port of ``flowstate_tpu/mcmc/initialise.py``, unchanged apart from using
the port's ``Box``.  Equivalents of the reference's ``MCMC/initialise.py``:

* ``initialise_fcc``            — 2-sublattice FCC-like lattice with
  center-out selection (``initialise.py:8-116``).
* ``initialise_low_left/right`` — small-N grid placements inside the
  left/right well (``initialise.py:118-210`` / ``:213-305``).
* ``initialise_fcc_left_half/right_half`` — half-box lattices
  (``initialise.py:393-458`` / ``:461-547``).  The reference's left-half
  variant is missing its ``return`` and silently yields ``None``
  (SURVEY.md §7, documented bug) — fixed here.
* ``init_alternating_wells``    — batch helper: chains alternate left/right
  starts like the hybrid drivers (main_algorithm_1.py:148-166).

All builders return ``(particles, box)`` with particles in the MC box frame
[0, L)^2.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from flowstate_tpu_torch.ops.box import Box


def _box(num_particles: int, rho: float, aspect_ratio: float) -> Box:
    return Box.from_density(num_particles, rho, aspect_ratio)


def _wrap(p: np.ndarray, box: Box) -> np.ndarray:
    return np.stack([p[..., 0] % box.size_x, p[..., 1] % box.size_y], axis=-1)


def initialise_fcc(num_particles: int = 48, rho: float = 0.5,
                   aspect_ratio: float = 1.5) -> Tuple[np.ndarray, Box]:
    """FCC-like 2-sublattice lattice, center-out selection; ref :8-116."""
    box = _box(num_particles, rho, aspect_ratio)
    nx = math.ceil(np.sqrt(num_particles / 2 * aspect_ratio))
    ny = math.ceil(num_particles / (2 * nx))
    dx = box.size_x / (nx - 0.5)
    dy = box.size_y / (ny - 0.5)

    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = np.stack([ii * dx, jj * dy], axis=-1).reshape(-1, 2)
    b = np.stack([(ii + 0.5) * dx, (jj + 0.5) * dy], axis=-1).reshape(-1, 2)
    candidates = _wrap(np.concatenate([a, b], axis=0), box)
    # The reference keeps PBC-coincident candidates (sublattice B's last
    # column/row wraps exactly onto sublattice A's first, initialise.py:76-78)
    # which can select two particles at the same site -> infinite energy.
    # Documented bug, not replicated: dedup wrapped sites, densify if short.
    candidates = np.unique(np.round(candidates, 9), axis=0)
    while len(candidates) < num_particles:
        nx += 1
        ny = math.ceil(num_particles / (2 * nx))
        dx = box.size_x / (nx - 0.5)
        dy = box.size_y / (ny - 0.5)
        ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        a = np.stack([ii * dx, jj * dy], axis=-1).reshape(-1, 2)
        b = np.stack([(ii + 0.5) * dx, (jj + 0.5) * dy],
                     axis=-1).reshape(-1, 2)
        candidates = np.unique(
            np.round(_wrap(np.concatenate([a, b], axis=0), box), 9), axis=0)

    center = np.array([box.size_x / 2, box.size_y / 2])
    order = np.argsort(np.sum((candidates - center) ** 2, axis=1),
                       kind="stable")
    return candidates[order[:num_particles]], box


def _grid_in_well(num_particles: int, box: Box,
                  group_center: np.ndarray) -> np.ndarray:
    """Grid placement around a well center; reference :154-194."""
    if num_particles == 1:
        return group_center[None, :].copy()
    grid_cols = int(np.ceil(np.sqrt(num_particles)))
    grid_rows = int(np.ceil(num_particles / grid_cols))
    max_sep_x = (box.size_x / (2 * (grid_cols - 1))
                 if grid_cols > 1 else np.inf)
    max_sep_y = (box.size_y / (grid_rows - 1) if grid_rows > 1 else np.inf)
    spacing = min(1.5, max_sep_x, max_sep_y)  # default_sep = 1.5 (:174)
    total_width = (grid_cols - 1) * spacing
    total_height = (grid_rows - 1) * spacing

    particles = []
    count = 0
    for row in range(grid_rows):
        for col in range(grid_cols):
            if count >= num_particles:
                break
            x = group_center[0] - total_width / 2 + col * spacing
            y = group_center[1] - total_height / 2 + row * spacing
            particles.append([x, y])
            count += 1
    return _wrap(np.asarray(particles), box)


def initialise_low_left(num_particles: int = 2, rho: float = 0.5,
                        aspect_ratio: float = 1.0) -> Tuple[np.ndarray, Box]:
    """Grid inside the left well; reference :118-210."""
    if not 1 <= num_particles <= 12:
        raise ValueError(
            "Number of particles for low initialization must be between 1 and 12.")
    box = _box(num_particles, rho, aspect_ratio)
    center = np.array([box.size_x / 4, box.size_y / 2])
    return _grid_in_well(num_particles, box, center), box


def initialise_low_right(num_particles: int = 2, rho: float = 0.5,
                         aspect_ratio: float = 1.0) -> Tuple[np.ndarray, Box]:
    """Grid inside the right well; reference :213-305."""
    if not 1 <= num_particles <= 12:
        raise ValueError(
            "Number of particles for low initialization must be between 1 and 12.")
    box = _box(num_particles, rho, aspect_ratio)
    center = np.array([3 * box.size_x / 4, box.size_y / 2])
    return _grid_in_well(num_particles, box, center), box


def _half_lattice(num_particles: int, box: Box,
                  x_lo: float, x_hi: float) -> np.ndarray:
    """Lattice filling [x_lo, x_hi) x [0, Ly); used by the half-box inits."""
    nx = math.ceil(np.sqrt(num_particles / 2))
    ny = math.ceil(num_particles / (2 * nx))
    width = x_hi - x_lo
    dx = width / (nx - 0.5) if nx > 1 else width
    dy = box.size_y / (ny - 0.5) if ny > 1 else box.size_y
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = np.stack([x_lo + ii * dx, jj * dy], axis=-1).reshape(-1, 2)
    b = np.stack([x_lo + (ii + 0.5) * dx, (jj + 0.5) * dy],
                 axis=-1).reshape(-1, 2)
    candidates = _wrap(np.concatenate([a, b], axis=0), box)
    center = np.array([(x_lo + x_hi) / 2, box.size_y / 2])
    order = np.argsort(np.sum((candidates - center) ** 2, axis=1),
                       kind="stable")
    return candidates[order[:num_particles]]


def initialise_fcc_left_half(num_particles: int = 48, rho: float = 0.5,
                             aspect_ratio: float = 1.5
                             ) -> Tuple[np.ndarray, Box]:
    """Half-box lattice in the left half; ref :393-458 (return bug fixed)."""
    box = _box(num_particles, rho, aspect_ratio)
    return _half_lattice(num_particles, box, 0.0, box.size_x / 2), box


def initialise_fcc_right_half(num_particles: int = 48, rho: float = 0.5,
                              aspect_ratio: float = 1.5
                              ) -> Tuple[np.ndarray, Box]:
    """Half-box lattice in the right half; ref :461-547."""
    box = _box(num_particles, rho, aspect_ratio)
    return _half_lattice(num_particles, box, box.size_x / 2, box.size_x), box


def init_split_wells(num_chains: int, num_particles: int, rho: float,
                     aspect_ratio: float = 1.0) -> Tuple[np.ndarray, Box]:
    """(C, N, 2) alternating left/right starts for ANY particle count.

    ``init_alternating_wells`` (in-well grids) up to its 12-particle
    limit; half-box lattices above (the N-scaling tools' convention,
    tools/hybrid_n_scaling.py).
    """
    if num_particles <= 12:
        return init_alternating_wells(num_chains, num_particles, rho,
                                      aspect_ratio)
    left, box = initialise_fcc_left_half(num_particles, rho, aspect_ratio)
    right, _ = initialise_fcc_right_half(num_particles, rho, aspect_ratio)
    pos = np.stack([left if i % 2 == 0 else right
                    for i in range(num_chains)])
    return pos, box


def init_alternating_wells(num_chains: int, num_particles: int, rho: float,
                           aspect_ratio: float = 1.0
                           ) -> Tuple[np.ndarray, Box]:
    """(C, N, 2) batch: even chains start left, odd chains right.

    Mirrors the hybrid drivers' per-run init (main_algorithm_1.py:148-166).
    """
    left, box = initialise_low_left(num_particles, rho, aspect_ratio)
    right, _ = initialise_low_right(num_particles, rho, aspect_ratio)
    stacked = np.stack([left if i % 2 == 0 else right
                        for i in range(num_chains)], axis=0)
    return stacked, box
