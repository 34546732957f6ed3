"""Radial distribution function g(r) over configuration stacks.

Port of ``flowstate_tpu/analysis/rdf.py::calculate_pair_correlation``
(:17), which is numpy: per-frame min-image pair distances, an
annulus-normalised histogram, averaged over frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def calculate_pair_correlation(samples: np.ndarray, n_particles: int,
                               bound: float, dr: Optional[float] = None,
                               normalization: str = "reference"
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """g(r) of centred-frame samples (T, N, 2) in [-bound, bound].

    ``dr`` defaults to bound / 50.  "reference" keeps the reference's
    scale (the full i != j distance matrix over n(n-1)/2, so an ideal gas
    reads 2/n); "physical" rescales by n/2 so an ideal gas reads 1.
    Returns (r values, g(r)).
    """
    if normalization not in ("reference", "physical"):
        raise ValueError(normalization)
    if dr is None:
        dr = bound / 50.0
    arr = np.asarray(samples, dtype=np.float64)
    t, n, _ = arr.shape
    box = 2.0 * bound

    diff = arr[:, :, None, :] - arr[:, None, :, :]
    diff -= box * np.round(diff / box)
    dist = np.sqrt(np.sum(diff * diff, axis=-1))      # (T, N, N)
    iu, ju = np.triu_indices(n, k=1)
    pair_d = dist[:, iu, ju]

    edges = np.arange(0.0, bound + dr, dr)
    counts = np.stack([np.histogram(pair_d[f], edges)[0] for f in range(t)])
    counts = counts * 2.0  # both (i, j) and (j, i), as the reference counts

    norm = n * (n - 1) / 2.0
    rho = n / (4.0 * bound * bound)
    i_vals = np.arange(0.0, bound, dr)
    area = np.pi * ((i_vals + dr) ** 2 - i_vals ** 2)
    g_r = (counts[:, :len(i_vals)] / (norm * rho * area)).mean(axis=0)
    if normalization == "physical":
        g_r = g_r * (n / 2.0)
    return i_vals, g_r
