"""Figures of the drivers, and the data behind them.

Port of the functions of ``flowstate_tpu/analysis/plots.py`` that the
port's drivers call; each writes SVG and PNG and returns their paths:

* ``plot_potential``       — MCMC/visualise.py:78-281 (heatmap +
  cross-section of the double well)
* ``visualise_simulation`` — MCMC/visualise.py:16-73
* ``plot_loss``, ``plot_frequency_heatmap``, ``plot_pair_correlation``,
  ``plot_acceptance_rate`` — utils.py:382-710 (Algorithm 1's figures);
* ``plot_avg_free_energy``, ``plot_well_statistics``,
  ``plot_avg_x_coordinate``, ``plot_multiple_avg_x_coordinates``,
  ``plot_state_histogram`` — utils.py:712-1038 and 144-221.

Each but the first two also writes ``<base_filename>_data.json``
(``_dump_json``) with the JAX functions' file names and keys.  Beside
them, the ICL style helpers (plots.py:70-123): ``ICL_COLOR_CYCLE``,
``set_icl_color_cycle`` and ``get_icl_heatmap_cmap``.

Matplotlib is imported inside the functions and runs headless (Agg), so
importing this module needs no matplotlib.  Where matplotlib cannot be
imported (the card's machine has none), a function draws no figure and
returns None for its paths: a figure is not a result, and the caller says
which figure it did not get.  The ``_data.json`` is a result and is
written either way.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flowstate_tpu_torch.analysis.wells import (
    STATE_LABELS, average_free_energy, state_histogram_counts,
)
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


# The ICL 12-colour palette, in the reference's order (MCMC/utils.py:42-56)
ICL_COLOR_CYCLE = (
    "#0000CD",  # Imperial Blue
    "#DC143C",  # Crimson
    "#008080",  # Teal
    "#FF4500",  # Orange Red
    "#FFFF00",  # Yellow
    "#C71585",  # Medium Violet Red
    "#006400",  # Dark Green
    "#4B0082",  # Indigo
    "#8B4513",  # Saddle Brown
    "#000080",  # Navy Blue
    "#708090",  # Slate Gray
    "#232323",  # Dark (near-black)
)

ICL_HEATMAP_STOPS = {
    "sequential": ["#000080", "#FFFF00"],
    "diverging": ["#0000CD", "#FFFFFF", "#DC143C"],
    "multistep": ["#0000CD", "#008080", "#FF4500", "#FFFF00"],
}


def set_icl_color_cycle(use_tex: bool = False) -> None:
    """Install the ICL colour cycle and the publication rcParams (TeX only
    with ``use_tex``); does nothing where matplotlib cannot be imported."""
    if _pyplot() is None:
        return
    import matplotlib
    from cycler import cycler

    matplotlib.rcParams["axes.prop_cycle"] = cycler(color=ICL_COLOR_CYCLE)
    matplotlib.rcParams.update({
        "text.usetex": use_tex,
        "font.family": "serif",
        "font.serif": ["Computer Modern Roman", "DejaVu Serif",
                       "Times New Roman", "Bitstream Vera Serif"],
        "figure.dpi": 300,
        "savefig.dpi": 300,
        "savefig.format": "svg",
    })


def get_icl_heatmap_cmap(cmap_type: str = "sequential"):
    """The ICL palette's heatmap colormap ``ICL_<Type>`` of
    ``ICL_HEATMAP_STOPS``; None where matplotlib cannot be imported."""
    if cmap_type not in ICL_HEATMAP_STOPS:
        raise ValueError(
            "Invalid cmap_type. Choose from 'sequential', 'diverging', or "
            "'multistep'.")
    if _pyplot() is None:
        return None
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list(
        f"ICL_{cmap_type.capitalize()}", ICL_HEATMAP_STOPS[cmap_type])


def _save(fig, directory: str, base_filename: str) -> Tuple[str, str]:
    os.makedirs(directory, exist_ok=True)
    svg = os.path.join(directory, f"{base_filename}.svg")
    png = os.path.join(directory, f"{base_filename}.png")
    fig.savefig(svg, bbox_inches="tight")
    fig.savefig(png, bbox_inches="tight")
    _pyplot().close(fig)
    return svg, png


def _dump_json(directory: str, base_filename: str, data: dict) -> str:
    """Write ``data`` to ``<directory>/<base_filename>_data.json``, numpy
    arrays as lists and numpy scalars as numbers."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{base_filename}_data.json")

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(data, f, default=default)
    return path


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


def plot_loss(loss_epoch: Sequence[float], directory: str,
              base_filename: str = "loss_plot"
              ) -> Optional[Tuple[str, str]]:
    """Training loss per epoch; utils.py:382-420."""
    _dump_json(directory, base_filename, {"loss_epoch": list(loss_epoch)})
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.arange(1, len(loss_epoch) + 1), loss_epoch)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title("Training loss")
    return _save(fig, directory, base_filename)


def plot_frequency_heatmap(samples_centered: np.ndarray, directory: str,
                           half_box: float, bins: int = 100,
                           base_filename: str = "frequency_heatmap"
                           ) -> Optional[Tuple[str, str]]:
    """2D position histogram of centred-frame samples; utils.py:452-528."""
    pts = np.asarray(samples_centered).reshape(-1, 2)
    h, xe, ye = np.histogram2d(
        pts[:, 0], pts[:, 1], bins=bins,
        range=[[-half_box, half_box], [-half_box, half_box]])
    _dump_json(directory, base_filename,
               {"histogram": h, "x_edges": xe, "y_edges": ye})
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(h.T, origin="lower", aspect="equal", cmap="viridis",
                   extent=[-half_box, half_box, -half_box, half_box])
    fig.colorbar(im, ax=ax, label="counts")
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    ax.set_title("Sample frequency heatmap")
    return _save(fig, directory, base_filename)


def plot_pair_correlation(r_vals: np.ndarray, g_r: np.ndarray,
                          directory: str,
                          base_filename: str = "pair_correlation_function"
                          ) -> Optional[Tuple[str, str]]:
    """g(r); utils.py:576-644."""
    _dump_json(directory, base_filename,
               {"r_vals": np.asarray(r_vals), "g_r": np.asarray(g_r)})
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(r_vals, g_r)
    ax.set_xlabel("$r$")
    ax.set_ylabel("$g(r)$")
    ax.set_title("Pair correlation function")
    return _save(fig, directory, base_filename)


def plot_acceptance_rate(p_acc_history: Sequence[float], directory: str,
                         x_values: Optional[Sequence[float]] = None,
                         xlabel: str = "Attempts",
                         base_filename: str = "acceptance_rate",
                         color: str = "C2") -> Optional[Tuple[str, str]]:
    """Big-move acceptance against attempts or moves; utils.py:646-710."""
    x = (list(x_values) if x_values is not None
         else list(range(len(p_acc_history))))
    _dump_json(directory, base_filename,
               {"x_values": x, "p_acc_history": list(p_acc_history)})
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(x, p_acc_history, color=color)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Acceptance rate")
    ax.set_ylim(-0.02, 1.02)
    ax.set_title("NF big-move acceptance rate")
    return _save(fig, directory, base_filename)


def plot_avg_free_energy(free_energy_array, directory: str,
                         color: str = "C2",
                         base_filename: str = "avg_free_energy"
                         ) -> Tuple[Optional[str], Optional[str], float, float,
                                    float]:
    """Across-run mean ΔF with SEM band; utils.py:712-794.

    Returns (svg, png, final_mean, final_sem, final_std); svg and png are
    None without matplotlib."""
    mean, sem, final_mean, final_sem, final_std = average_free_energy(
        free_energy_array)
    _dump_json(directory, base_filename,
               {"mean": mean, "sem": sem, "final_mean": final_mean,
                "final_sem": final_sem, "final_std": final_std})
    plt = _pyplot()
    if plt is None:
        return None, None, final_mean, final_sem, final_std
    runs = np.arange(1, len(mean) + 1)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(runs, mean, color=color, label=r"$\langle\Delta F\rangle$")
    ax.fill_between(runs, mean - sem, mean + sem, color=color, alpha=0.3,
                    label="SEM")
    ax.set_xlabel("Sample")
    ax.set_ylabel(r"$\Delta F / k_B T$")
    ax.set_title(
        rf"Final $\Delta F$ = {final_mean:.3f} $\pm$ {final_sem:.3f} $k_BT$")
    ax.legend()
    svg, png = _save(fig, directory, base_filename)
    return svg, png, final_mean, final_sem, final_std


def plot_well_statistics(avg_x_values, p_a_values, p_b_values,
                         deltaF_values, runs, half_box: float,
                         directory: str,
                         base_filename: str = "well_statistics"
                         ) -> Optional[Tuple[str, str]]:
    """3-panel ⟨x⟩ / occupancies / ΔF; utils.py:796-880."""
    _dump_json(directory, base_filename,
               {"avg_x": np.asarray(avg_x_values),
                "p_a": np.asarray(p_a_values),
                "p_b": np.asarray(p_b_values),
                "deltaF": np.asarray(deltaF_values),
                "runs": np.asarray(runs)})
    plt = _pyplot()
    if plt is None:
        return None
    fig, axes = plt.subplots(3, 1, figsize=(9, 11), sharex=True)
    axes[0].plot(runs, avg_x_values, lw=0.7)
    axes[0].axhline(half_box, color="gray", ls="--", lw=0.8)
    axes[0].set_ylabel(r"$\langle x \rangle$")
    axes[1].plot(runs, p_a_values, label="P(A)")
    axes[1].plot(runs, p_b_values, label="P(B)")
    axes[1].set_ylabel("Occupancy")
    axes[1].legend()
    axes[2].plot(runs, deltaF_values, color="C3")
    axes[2].set_ylabel(r"$\Delta F / k_B T$")
    axes[2].set_xlabel("Sample")
    fig.suptitle("Well statistics")
    return _save(fig, directory, base_filename)


def plot_avg_x_coordinate(configs: np.ndarray, directory: str,
                          half_box: float, run_idx: int = 1,
                          base_filename: Optional[str] = None
                          ) -> Optional[Tuple[str, str]]:
    """Per-particle and mean x trajectories; utils.py:883-958."""
    base_filename = base_filename or f"avg_x_coordinate_run_{run_idx}"
    arr = np.asarray(configs)  # (T, N, 2)
    _dump_json(directory, base_filename, {"x": arr[..., 0]})
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(9, 5))
    for p in range(arr.shape[1]):
        ax.plot(arr[:, p, 0], lw=0.5, alpha=0.6, label=f"particle {p}")
    ax.plot(arr[..., 0].mean(axis=1), color="k", lw=1.2, label="mean")
    ax.axhline(half_box, color="gray", ls="--", lw=0.8)
    ax.set_xlabel("Sample")
    ax.set_ylabel("$x$")
    ax.set_title(f"x-coordinates — run {run_idx}")
    ax.legend(fontsize=7)
    return _save(fig, directory, base_filename)


def plot_multiple_avg_x_coordinates(configs_per_run, directory: str,
                                    base_filename: str = "multi_avg_x"
                                    ) -> Optional[Tuple[str, str]]:
    """⟨x⟩ of the first <=10 runs on one grid; utils.py:961-1038."""
    means = [np.asarray(cfg)[..., 0].mean(axis=1)
             for cfg in list(configs_per_run)[:10]]
    _dump_json(directory, base_filename,
               {f"run_{i}": m for i, m in enumerate(means)})
    plt = _pyplot()
    if plt is None:
        return None
    fig, axes = plt.subplots(5, 2, figsize=(12, 14), sharex=True)
    for i, (ax, mean_x) in enumerate(zip(axes.ravel(), means)):
        ax.plot(mean_x, lw=0.7)
        ax.set_title(f"run {i + 1}", fontsize=8)
    fig.suptitle(r"$\langle x \rangle$ per run")
    return _save(fig, directory, base_filename)


def plot_state_histogram(classifications: np.ndarray, directory: str,
                         base_filename: str = "state_histogram"
                         ) -> Optional[Tuple[str, str]]:
    """Share of configurations in each well state; utils.py:144-221."""
    counts = state_histogram_counts(classifications)
    _dump_json(directory, base_filename, {"state_counts": counts})
    plt = _pyplot()
    if plt is None:
        return None
    total = max(sum(counts.values()), 1)
    fig, ax = plt.subplots(figsize=(10, 6))
    for i, state in enumerate(STATE_LABELS):
        pct = 100.0 * counts[state] / total
        ax.bar(i, pct, alpha=0.7, label=state)
    ax.set_xticks(range(len(STATE_LABELS)))
    ax.set_xticklabels(STATE_LABELS, rotation=45, ha="right")
    ax.set_ylabel("Percentage of Configurations / %")
    ax.set_title("Distribution of System States")
    ax.legend()
    return _save(fig, directory, base_filename)
