"""Figures of the single-run CLI.

Port of two functions of ``flowstate_tpu/analysis/plots.py``, the ones
``experiments/single_run.py`` calls; each writes SVG and PNG and returns
their paths:

* ``plot_potential``       — MCMC/visualise.py:78-281 (heatmap +
  cross-section of the double well)
* ``visualise_simulation`` — MCMC/visualise.py:16-73

Matplotlib is imported inside the functions and runs headless (Agg), so
importing this module needs no matplotlib.  Where matplotlib cannot be
imported (the card's machine has none), a function writes nothing and
returns None: a figure is not a result, and the caller says which figure
it did not get.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flowstate_tpu_torch.ops.potentials import (
    double_well_potential, well_centers,
)


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    cannot be imported."""
    try:
        import matplotlib
    except ImportError:
        return None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, directory: str, base_filename: str) -> Tuple[str, str]:
    os.makedirs(directory, exist_ok=True)
    svg = os.path.join(directory, f"{base_filename}.svg")
    png = os.path.join(directory, f"{base_filename}.png")
    fig.savefig(svg, bbox_inches="tight")
    fig.savefig(png, bbox_inches="tight")
    _pyplot().close(fig)
    return svg, png


def plot_potential(box_size_x: float, box_size_y: float,
                   V0_list, r0: float, k: float, num_wells: int,
                   output_path: str,
                   base_filename: str = "potential"
                   ) -> Optional[Tuple[str, str]]:
    """Double-well heatmap + x-cross-section; MCMC/visualise.py:78-281.
    None, and no file, without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    g = 200
    xs = np.linspace(0, box_size_x, g)
    ys = np.linspace(0, box_size_y, g)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], axis=-1),
                          dtype=torch.float32)
    V = double_well_potential(
        pts, box_size_x, box_size_y, V0_list=list(V0_list), r0=r0, k=k,
        num_wells=num_wells).numpy().reshape(g, g)
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(13, 5))
    im = ax0.imshow(V.T, origin="lower", aspect="equal", cmap="viridis",
                    extent=[0, box_size_x, 0, box_size_y])
    fig.colorbar(im, ax=ax0, label="V(x, y)")
    # the wells' centers (Lx/4, Ly/2) and (3Lx/4, Ly/2); the JAX package
    # labels them at y = Lx/2, off the wells when the box is not square
    centers = well_centers(box_size_x, box_size_y, 2)
    ax0.annotate("A", centers[0], color="w", fontsize=14, ha="center")
    if num_wells == 2:
        ax0.annotate("B", centers[1], color="w", fontsize=14, ha="center")
    ax0.set_xlabel("$x$")
    ax0.set_ylabel("$y$")
    mid = g // 2
    ax1.plot(xs, V[:, mid])
    ax1.set_xlabel("$x$")
    ax1.set_ylabel(f"V(x, y={box_size_y / 2:.1f})")
    ax1.set_title("Cross-section through the wells")
    return _save(fig, output_path, base_filename)


def visualise_simulation(configs: Sequence[np.ndarray], box_size_x: float,
                         box_size_y: float, directory: str,
                         base_filename: str = "simulation_snapshots"
                         ) -> Optional[Tuple[str, str]]:
    """Up to 6 configuration snapshots; MCMC/visualise.py:16-73.  None, and
    no file, without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    configs = list(configs)[:6]
    n = len(configs)
    cols = min(3, max(n, 1))
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                             squeeze=False)
    for ax, cfg in zip(axes.ravel(), configs):
        arr = np.asarray(cfg)
        ax.scatter(arr[:, 0], arr[:, 1], alpha=0.7)
        ax.set_xlim(0, box_size_x)
        ax.set_ylim(0, box_size_y)
        ax.set_aspect("equal")
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    return _save(fig, directory, base_filename)
