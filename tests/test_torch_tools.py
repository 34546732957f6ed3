"""The port's gate and sampler tools against the JAX package's tools.

* The quadrature (``tools/exact_free_energy.py``) on the JAX tool's own
  numpy draws: ln Z of each region, ΔF, the sector probabilities and the
  particle-level ΔF within 1e-10 in float64, through the plain float64
  energy and through the function the tool calls on the CPU.
* The helpers (``sector_labels``, ``well_counts``, ``well_state``,
  ``occupancy``, ``weighted_particle_df``, ``_summary``, ``_observe``,
  ``render_section``) against the JAX tools' on the same arrays: labels
  and counts exactly, float64 sums to 1e-12, float32 means to 1e-6.
* Each tool's ``main([..., "--device", "cpu"])`` at a tiny size: the keys
  of the JAX tool's result (read from its source), finite numbers, and
  files only where asked; without ``--device`` each raises, there being
  no card here.

The JAX tools are imported from the repository's ``tools/`` (as
``tests/test_demos.py`` imports ``make_notebooks``); the port never
imports them.
"""

import ast
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch.ops.cuda_pair import total_energy_virial_plain
from flowstate_tpu_torch.tools import (
    alpha_study, blocked_depth, blocked_wall, ess_check, exact_free_energy,
    hybrid_n_scaling, move_kernel_check, n_mitigation, pt_mbar_oracle,
    sampler_bench, sector_check, within_well_bench,
)
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import double_well_spec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
QUAD = dict(rtol=0, atol=1e-10)
TINY_FLOW = dict(K=2, hidden_units=16, num_bins=4)
TIGHT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def jtools():
    """The JAX package's tools as modules (imported with JAX's persistent
    compilation cache, which some of them switch on, left off)."""
    from flowstate_tpu.utils import profiling

    enable = profiling.enable_compilation_cache
    profiling.enable_compilation_cache = lambda *args, **kwargs: None
    sys.path.insert(0, TOOLS)
    try:
        import exact_free_energy as jexact
        import ess_check as jess
        import pallas_check as jpallas
        import pt_mbar_oracle as jpt
        import sampler_bench as jsampler
        import sector_check as jsector
        import within_well_bench as jwithin
    finally:
        sys.path.remove(TOOLS)
        profiling.enable_compilation_cache = enable
    return dict(exact=jexact, ess=jess, pallas=jpallas, pt=jpt,
                sampler=jsampler, sector=jsector, within=jwithin)


# ----- the quadrature --------------------------------------------------------

@pytest.mark.parametrize("region", ["A", "B", "AAB", "ABB"])
def test_log_partition_equals_the_numpy_tool_on_its_draws(jtools, region):
    m = 30_000
    want = jtools["exact"].log_partition(region, m,
                                         np.random.default_rng(5))
    # the plain float64 energy on the tool's points
    points = exact_free_energy.disk_points(region, m,
                                           np.random.default_rng(5), "cpu")
    energy = total_energy_virial_plain(double_well_spec(3), points)[0]
    assert energy.dtype == torch.float64
    plain = exact_free_energy.log_mean_boltzmann(energy)
    # what the tool calls on the CPU
    tool = exact_free_energy.log_partition(region, m,
                                           np.random.default_rng(5), "cpu")
    np.testing.assert_allclose([plain, tool], [want, want], **QUAD)


def test_delta_f_sectors_and_particle_df_equal_the_numpy_tools(jtools):
    m = 20_000
    np.testing.assert_allclose(
        exact_free_energy.exact_delta_f(m, 3, "cpu"),
        jtools["exact"].exact_delta_f(m, 3), **QUAD)
    want = jtools["exact"].exact_sector_probs(m, 4)
    got = exact_free_energy.exact_sector_probs(m, 4, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **QUAD)
    np.testing.assert_allclose(
        exact_free_energy.exact_particle_df(4000, 3, "cpu"),
        jtools["ess"].exact_particle_df(4000, 3), **QUAD)


def test_overlaps_weigh_zero_and_stay_in_the_denominator():
    e = torch.tensor([1.0, 2.0, math.inf, math.inf], dtype=torch.float64)
    want = math.log((math.exp(-1.0) + math.exp(-2.0)) / 4)
    np.testing.assert_allclose(exact_free_energy.log_mean_boltzmann(e),
                               want, **TIGHT)


def test_the_card_draws_are_a_quadrature_too():
    """A torch generator's draws (the card's stream) on the CPU: a
    different stream, the same integral."""
    g = torch.Generator().manual_seed(0)
    lz = {region: exact_free_energy.log_partition_of_points(
        exact_free_energy.disk_points(region, 100_000, g, "cpu"))
        for region in ("A", "B")}
    assert abs(lz["B"] - lz["A"] - 1.484) < 0.05


# ----- the helpers -----------------------------------------------------------

def random_positions(c, n, seed, lx=10.0):
    rng = np.random.default_rng(seed)
    return (rng.random((c, n, 2)) * lx).astype(np.float32)


def test_sector_labels_equal_jax(jtools):
    pos = random_positions(24, 3, 1).reshape(4, 6, 3, 2)
    # in-well configurations too, so that every sector appears
    pos[:, :3] = np.where(np.arange(3)[:, None] < 2, [2.5, 5.0], [7.5, 5.0])
    want = jtools["sector"].sector_labels(pos, 5.0)
    np.testing.assert_array_equal(sector_check.sector_labels(pos, 5.0), want)


def test_well_counts_state_and_occupancy_equal_jax(jtools):
    n = 8
    jspec = jops.SystemSpec.create(n, jops.Box.from_density(n, 0.03),
                                   num_wells=2, V0_list=(-10.0, -10.5),
                                   r0=1.2, k=15.0)
    tspec = double_well_spec(n)
    pos = random_positions(64, n, 2, jspec.box.size_x)
    j_a, j_b = jtools["ess"].well_counts(jspec, jnp.asarray(pos))
    t_a, t_b = ess_check.well_counts(tspec, torch.as_tensor(pos))
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
    np.testing.assert_array_equal(t_b.numpy(), np.asarray(j_b))
    np.testing.assert_array_equal(
        ess_check.well_state(tspec, torch.as_tensor(pos)).numpy(),
        np.asarray(jtools["ess"].well_state(jspec, jnp.asarray(pos))))
    np.testing.assert_allclose(
        move_kernel_check.occupancy(tspec, torch.as_tensor(pos)),
        jtools["pallas"].occupancy(jspec, jnp.asarray(pos)), rtol=1e-6)


def test_weighted_particle_df_and_summary_equal_jax(jtools):
    rng = np.random.default_rng(3)
    log_w = rng.normal(0, 3, 500)
    log_w[:20] = -np.inf
    n_a, n_b = rng.integers(0, 4, 500), rng.integers(0, 4, 500)
    np.testing.assert_allclose(
        pt_mbar_oracle.weighted_particle_df(log_w, n_a, n_b),
        jtools["pt"].weighted_particle_df(log_w, n_a, n_b), **TIGHT)
    obs = (rng.random((16, 60)) < 0.5).astype(np.float64)
    obs[:8] = np.repeat(rng.random((8, 1)) < 0.5, 60, axis=1)
    for counts in ((1200.0, 830.0), None):
        assert (sampler_bench._summary("x y", obs, counts, 1.7, 0.42)
                == jtools["sampler"]._summary("x y", obs, counts, 1.7, 0.42))


def test_observe_and_render_section_equal_jax(jtools):
    n = 4
    jspec = jops.SystemSpec.create(n, jops.Box.from_density(n, 0.03),
                                   num_wells=1, V0_list=(-10.0,), r0=1.2,
                                   k=15.0)
    tspec = double_well_spec(n, num_wells=1, v0=(-10.0,))
    pos = random_positions(12, n, 4, jspec.box.size_x)
    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos), jax.random.key(0))
    ts = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0)
    for mine, ref in zip(within_well_bench._observe(tspec, ts),
                         jtools["within"]._observe(jspec, js)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    rows = [{"sampler": s, "n": n, "acceptance": 0.5 + i / 10,
             "energy_ess_per_s": 100.0 * i, "meanx_ess_per_s": 7.5,
             **({"energy_ess_per_Mgrad": 3.0} if i else {})}
            for n in (3, 32) for i, s in enumerate(("metropolis", "mala",
                                                    "hmc"))]
    data = {"rows": rows, "rounds": 600, "systems": [[3, 1024], [32, 256]],
            "verdict": within_well_bench.build_verdict(rows)}
    assert (within_well_bench.render_section(data)
            == jtools["within"].render_section(data))


# ----- the tools' entry points -----------------------------------------------

def jax_result_keys(tool: str, var: str, func: str) -> set:
    """The constant keys of the dict literal assigned to ``var`` in
    ``func`` of the JAX tool's source."""
    with open(os.path.join(TOOLS, f"{tool}.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == var
                        for t in node.targets)):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    raise AssertionError(f"no {var} dict in {tool}.{func}")


def all_finite(value) -> bool:
    if isinstance(value, dict):
        return all(all_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(all_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


REPORTS = ("ESS.md", "PALLAS.md", "SAMPLERS.md", "SECTORS.md",
           "TEMPERING.md")


def snapshot():
    """The root reports' and the evidence directory's state."""
    ev = os.path.join(REPO, "results", "evidence")
    return ({r: os.stat(os.path.join(REPO, r)).st_mtime_ns for r in REPORTS},
            sorted(os.listdir(ev)))


def run_tool(module, argv, tmp_path, monkeypatch):
    # the tools' fixed 5000-move equilibration, cut to the tiny sizes here
    monkeypatch.setattr(common, "EQUILIBRATION_MOVES", 300)
    before = snapshot()
    monkeypatch.chdir(tmp_path)
    evidence = str(tmp_path / "out" / "evidence.json")
    result = module.main(argv + ["--device", "cpu", "--evidence", evidence])
    assert snapshot() == before
    assert sorted(os.listdir(tmp_path)) == ["out"]
    with open(evidence) as f:
        assert json.load(f)
    return result


def test_exact_free_energy_main(tmp_path, monkeypatch):
    res = run_tool(exact_free_energy, ["--samples", "4000", "--sectors",
                                       "--particle"], tmp_path, monkeypatch)
    assert all_finite(res) and 1.2 < res["delta_f"] < 1.8
    assert set(res["sector_probs"]) == {"AAA", "AAB", "ABB", "BBB",
                                        "dF_pure"}


def test_sector_check_main(tmp_path, monkeypatch, jtools):
    rng = np.random.default_rng(6)
    centers = np.array([[2.5, 5.0], [7.5, 5.0]])
    side = rng.integers(0, 2, (6, 80, 3))
    pos = centers[side] + rng.normal(0, 0.4, (6, 80, 3, 2))
    path = tmp_path / "out" / "production_positions.npy"
    path.parent.mkdir()
    np.save(path, pos.astype(np.float32))
    argv = [str(path), "--quad_samples", "3000", "--block", "10"]
    res = run_tool(sector_check, argv, tmp_path, monkeypatch)
    # the JAX tool on the same file: the same numbers (the CPU path takes
    # the numpy tool's draws, the bootstrap the same generator)
    want = jtools["sector"].main(argv + ["--out", str(tmp_path / "out" /
                                                      "SECTORS.md")])
    assert set(want) <= set(res)
    for k in want:
        assert res[k] == want[k], k


def test_move_kernel_check_main(tmp_path, monkeypatch):
    res = run_tool(move_kernel_check, [
        "--chains", "16", "--moves", "20"], tmp_path, monkeypatch)
    assert set(jax_result_keys("pallas_check", "result", "main")) <= set(res)
    assert all_finite(res) and res["ok"] and res["virial_poisoned"]


def test_ess_check_main(tmp_path, monkeypatch):
    monkeypatch.setattr(ess_check, "FLOW_WIDTHS", TINY_FLOW)
    res = run_tool(ess_check, [
        "--chains", "8", "--rounds", "12", "--moves_per_round", "10",
        "--epochs", "1", "--exact_samples", "2000", "--exact_seeds", "2"],
        tmp_path, monkeypatch)
    assert set(jax_result_keys("ess_check", "result", "main")) <= set(res)
    assert all_finite({k: v for k, v in res.items() if k != "value"})


def test_pt_mbar_oracle_main(tmp_path, monkeypatch):
    res = run_tool(pt_mbar_oracle, [
        "--n_list", "3,8", "--replicas", "3", "--walkers", "4",
        "--pt_rounds", "15", "--moves_per_round", "5", "--mbar_iters", "50"],
        tmp_path, monkeypatch)
    assert res["metric"] == "pt_mbar_oracle" and set(res["df"]) == {3, 8}
    for system in res["systems"].values():
        assert set(jax_result_keys("pt_mbar_oracle", "out",
                                   "run_for_n")) <= set(system)
    assert all_finite(res)


def test_sampler_bench_main(tmp_path, monkeypatch):
    monkeypatch.setattr(ess_check, "FLOW_WIDTHS", TINY_FLOW)
    # the quadrature's 4 x 4 x 4e6 points, cut
    monkeypatch.setattr(
        sampler_bench, "exact_particle_df",
        lambda device: exact_free_energy.exact_particle_df(2000, 2, device))
    res = run_tool(sampler_bench, [
        "--chains", "20", "--rounds", "12", "--moves_per_round", "10",
        "--epochs", "1", "--mala_equilibration", "20",
        "--hmc_equilibration", "10"], tmp_path, monkeypatch)
    assert set(jax_result_keys("sampler_bench", "result", "main")) <= set(res)
    row_keys = jax_result_keys("sampler_bench", "row", "_summary")
    assert len(res["rows"]) == 5
    for row in res["rows"]:
        assert row_keys <= set(row) and "df_particle" in row
    assert all_finite(res)


def test_within_well_bench_main(tmp_path, monkeypatch):
    res = run_tool(within_well_bench, [
        "--systems", "3:8", "--rounds", "12", "--mala_equilibration", "20",
        "--hmc_equilibration", "10"], tmp_path, monkeypatch)
    assert set(jax_result_keys("within_well_bench", "data", "main")) <= set(res)
    row_keys = jax_result_keys("within_well_bench", "row", "bench_system")
    assert [r["sampler"] for r in res["rows"]] == ["metropolis", "mala", "hmc"]
    for row in res["rows"]:
        assert row_keys <= set(row)
    assert all_finite(res)


@pytest.mark.parametrize("module", [
    exact_free_energy, move_kernel_check, ess_check, pt_mbar_oracle,
    sampler_bench, within_well_bench, hybrid_n_scaling, n_mitigation,
    blocked_wall, blocked_depth, alpha_study])
def test_tools_default_to_the_card(module):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
