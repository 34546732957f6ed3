"""Well-occupancy observables: classification, P(A)/P(B), ΔF, state counts.

Port of ``flowstate_tpu/analysis/wells.py``: numpy on the host, and
``well_counts_device`` in torch on the tensors' own device (the tempering
driver's per-round record).  Equivalents of the reference's analysis
utilities:

* ``classify_particles``          — A/B/Outside via disks of radius 1.1*r0
  around the well centers, min-image PBC
  (``hybrid_NF_MCMC/utils.py:104-141``).
* ``calculate_well_statistics``   — cumulative P(A), P(B),
  ΔF = ln(P_B / P_A), running ⟨x⟩ (``utils.py:61-101``).
* ``state_histogram_counts``      — AllA / 1A2B / 2A1B / AllB / Outside
  (``utils.py:144-221``).
* ``average_free_energy``         — across-run mean ΔF with SEM/std
  (``utils.py:712-794``).

Implemented as vectorized numpy over (T, N, 2) configuration stacks (these
run on host after device sampling; the classification itself is a trivial
broadcast and never the bottleneck).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# classification codes
WELL_A, WELL_B, OUTSIDE = 0, 1, 2

STATE_LABELS = ("All A", "1A2B", "2A1B", "All B", "Outside")


def well_centers(half_box: float) -> np.ndarray:
    """Centers in the MC box frame: (L/4, L/2) and (3L/4, L/2)."""
    L = 2.0 * half_box
    return np.array([[L / 4.0, L / 2.0], [3.0 * L / 4.0, L / 2.0]])


def classify_particles(positions: np.ndarray, half_box: float,
                       r0: float) -> np.ndarray:
    """Classify each particle as WELL_A / WELL_B / OUTSIDE.

    positions: (..., N, 2) in the MC box frame [0, L)^2.
    Radius is ``1.1 * r0`` (reference utils.py:111); min-image PBC applied.
    Returns int array (..., N).
    """
    pos = np.asarray(positions, dtype=np.float64)
    L = 2.0 * half_box
    centers = well_centers(half_box)  # (2, 2)
    radius = 1.1 * r0
    d = pos[..., None, :] - centers  # (..., N, 2wells, 2)
    d -= L * np.round(d / L)
    inside = np.sum(d * d, axis=-1) <= radius**2  # (..., N, 2)
    out = np.full(pos.shape[:-1], OUTSIDE, dtype=np.int8)
    out[inside[..., 1]] = WELL_B
    out[inside[..., 0]] = WELL_A  # left wins if (impossibly) both
    return out


def well_counts_device(positions, half_box: float, r0: float = 1.2):
    """Per-configuration well occupation counts ``(n_A, n_B)`` of a
    (..., N, 2) tensor in the MC box frame, on its own device: the circles
    of :func:`classify_particles` (radius 1.1 r0, minimum image).  Each
    count is (...,) int64.  Meant for ``record_fn`` hooks that keep the
    observables on the card instead of copying every replica's positions
    (``mcmc/tempering.py``, the PT production driver)."""
    import torch

    L = 2.0 * half_box
    radius = 1.1 * r0
    centers = torch.as_tensor(well_centers(half_box), dtype=positions.dtype,
                              device=positions.device)
    d = positions[..., None, :] - centers          # (..., N, 2wells, 2)
    d = d - L * torch.round(d / L)
    inside = torch.sum(d * d, dim=-1) <= radius ** 2   # (..., N, 2)
    n_a = torch.sum(inside[..., 0], dim=-1)
    n_b = torch.sum(inside[..., 1], dim=-1)
    return n_a, n_b


def calculate_well_statistics(configurations: np.ndarray, start_idx: int,
                              half_box: float, r0: float = 1.2
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """Cumulative well statistics over a trajectory.

    Returns (avg_x, p_a, p_b, deltaF, runs) exactly as reference
    ``utils.py:61-101``: cumulative counts of all-in-A / all-in-B
    configurations, ΔF = ln(p_b / p_a) where both are nonzero else 0.
    """
    configs = np.asarray(configurations)[start_idx:]
    cls = classify_particles(configs, half_box, r0)  # (T, N)
    avg_x = configs[..., 0].mean(axis=-1)

    all_a = np.all(cls == WELL_A, axis=-1)
    all_b = np.all(cls == WELL_B, axis=-1)
    runs = np.arange(1, len(configs) + 1)
    p_a = np.cumsum(all_a) / runs
    p_b = np.cumsum(all_b) / runs
    with np.errstate(divide="ignore", invalid="ignore"):
        deltaF = np.where((p_a > 0) & (p_b > 0), np.log(p_b / p_a), 0.0)
    return avg_x, p_a, p_b, deltaF, runs


def state_histogram_counts(classifications: np.ndarray) -> Dict[str, int]:
    """Count 3-particle system states; reference ``utils.py:163-181``."""
    cls = np.asarray(classifications)
    num_a = np.sum(cls == WELL_A, axis=-1)
    num_b = np.sum(cls == WELL_B, axis=-1)
    num_out = np.sum(cls == OUTSIDE, axis=-1)
    counts = {
        "All A": int(np.sum((num_out == 0) & (num_a == 3))),
        "1A2B": int(np.sum((num_out == 0) & (num_a == 1) & (num_b == 2))),
        "2A1B": int(np.sum((num_out == 0) & (num_a == 2) & (num_b == 1))),
        "All B": int(np.sum((num_out == 0) & (num_b == 3))),
        "Outside": int(np.sum(num_out > 0)),
    }
    return counts


def average_free_energy(free_energy_array: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, float, float, float]:
    """Mean ΔF trajectory across runs with SEM band.

    Returns (mean_series, sem_series, final_mean, final_sem, final_std);
    reference ``plot_avg_free_energy`` data path (utils.py:712-794).
    """
    arr = np.asarray(free_energy_array, dtype=np.float64)  # (R, T)
    mean = arr.mean(axis=0)
    std = arr.std(axis=0, ddof=0)
    sem = std / np.sqrt(arr.shape[0])
    return mean, sem, float(mean[-1]), float(sem[-1]), float(std[-1])
