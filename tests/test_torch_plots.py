"""The port's figure functions (``flowstate_tpu_torch.analysis.plots``)
against the JAX package's: each writes a ``<name>_data.json`` equal to the
JAX function's on the same numpy arrays (``json.load`` equality, floats to
1e-12: both compute the same float64 statistics with numpy), and writes it
whether or not matplotlib can be imported.
"""

import json
import math

import numpy as np
import pytest

from flowstate_tpu.analysis import plots as jplots
from flowstate_tpu.analysis.wells import (
    calculate_well_statistics as j_well_statistics,
)
from flowstate_tpu.analysis.rdf import (
    calculate_pair_correlation as j_pair_correlation,
)
from flowstate_tpu.analysis.wells import classify_particles as j_classify
from flowstate_tpu_torch.analysis import plots as tplots
from flowstate_tpu_torch.analysis.rdf import calculate_pair_correlation

HALF_BOX = 5.0


def _same(a, b, path="data"):
    """``a`` and ``b`` (loaded JSON) equal, floats to 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _trajectories(seed, runs=12, samples=40, n=3):
    """(runs, T, N, 2) positions around the two wells of a 10 x 10 box."""
    rng = np.random.default_rng(seed)
    centers = np.array([[2.5, 5.0], [7.5, 5.0]])
    which = rng.integers(0, 2, size=(runs, samples, n))
    return (centers[which] + rng.normal(0.0, 0.7, (runs, samples, n, 2))
            ).astype(np.float32)


def _call(module, name, seed, directory):
    """Call ``module.<name>`` on the inputs made from ``seed``."""
    configs = _trajectories(seed)
    fn = getattr(module, name)
    rng = np.random.default_rng(seed)
    if name == "plot_loss":
        return fn(list(rng.normal(-5.0, 2.0, 17)), directory)
    if name == "plot_frequency_heatmap":
        return fn(configs.reshape(-1, 3, 2) - HALF_BOX, directory, HALF_BOX)
    if name == "plot_pair_correlation":
        r, g = j_pair_correlation(configs[0] - HALF_BOX, 3, HALF_BOX)
        return fn(r, g, directory)
    if name == "plot_acceptance_rate":
        p_acc = np.cumsum(rng.random(30)) / np.arange(1, 31)
        return fn([0.0] + list(p_acc), directory,
                  x_values=[150 * 4 * i for i in range(31)],
                  xlabel="MCMC Steps", base_filename="nf_acceptance_rate")
    if name == "plot_avg_free_energy":
        rng = np.random.default_rng(seed)
        return fn(rng.normal(0.3, 0.2, size=(12, 40)), directory)
    if name == "plot_well_statistics":
        stats = j_well_statistics(configs[0], 0, HALF_BOX, 1.2)
        return fn(*stats, HALF_BOX, directory)
    if name == "plot_avg_x_coordinate":
        return fn(configs[3], directory, HALF_BOX, 4)
    if name == "plot_multiple_avg_x_coordinates":
        return fn(list(configs), directory)
    labels = j_classify(configs.reshape(-1, 3, 2), HALF_BOX, 1.2)
    return fn(labels, directory)


FUNCTIONS = {
    "plot_loss": "loss_plot_data.json",
    "plot_frequency_heatmap": "frequency_heatmap_data.json",
    "plot_pair_correlation": "pair_correlation_function_data.json",
    "plot_acceptance_rate": "nf_acceptance_rate_data.json",
    "plot_avg_free_energy": "avg_free_energy_data.json",
    "plot_well_statistics": "well_statistics_data.json",
    "plot_avg_x_coordinate": "avg_x_coordinate_run_4_data.json",
    "plot_multiple_avg_x_coordinates": "multi_avg_x_data.json",
    "plot_state_histogram": "state_histogram_data.json",
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_data_json_equals_the_jax_functions(name, tmp_path):
    j_out = _call(jplots, name, 7, str(tmp_path / "jax"))
    t_out = _call(tplots, name, 7, str(tmp_path / "port"))
    data = FUNCTIONS[name]
    _same(json.loads((tmp_path / "jax" / data).read_text()),
          json.loads((tmp_path / "port" / data).read_text()))
    assert [p.endswith(".svg") for p in t_out[:2]] == [True, False]
    assert [p.endswith(".svg") for p in j_out[:2]] == [True, False]
    if name == "plot_avg_free_energy":
        np.testing.assert_allclose(t_out[2:], j_out[2:], rtol=1e-12)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_data_json_is_written_without_matplotlib(name, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(tplots, "_pyplot", lambda: None)
    out = _call(tplots, name, 8, str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [FUNCTIONS[name]]
    if name == "plot_avg_free_energy":
        assert out[:2] == (None, None)
        assert all(np.isfinite(out[2:]))
    else:
        assert out is None


@pytest.mark.parametrize("normalization", ["reference", "physical"])
@pytest.mark.parametrize("dr", [None, 0.1])
def test_pair_correlation_matches_jax(normalization, dr):
    samples = _trajectories(9, runs=1, samples=200)[0] - HALF_BOX
    j_r, j_g = j_pair_correlation(samples, 3, HALF_BOX, dr=dr,
                                  normalization=normalization)
    t_r, t_g = calculate_pair_correlation(samples, 3, HALF_BOX, dr=dr,
                                          normalization=normalization)
    np.testing.assert_array_equal(t_r, j_r)
    np.testing.assert_array_equal(t_g, j_g)
