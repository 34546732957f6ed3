"""The port's sweep (``flowstate_tpu_torch.experiments.sweep``), its locked
CSV fan-in (``flowstate_tpu_torch.io.aggregate``) and the single-run CLI
without matplotlib, against the JAX package.

Aggregation: the locked append (header once, then rows), 4 processes x
50 rows with no torn line, and the two packages' ``append_results`` on one
``sampled_data.csv``.  The sweep: the small grid of
tests/test_io_and_cli.py::test_sweep_runner through both packages on the
CPU; the same job directories and ``parameters.json``, and equal
temperature, density and aspect-ratio columns to 1e-6 (the box is fixed
by the grid point).  The two packages draw different random streams, so
there their pressures are held finite, not equal; with each grid point's
run replaced by one that writes the same ``sampled_data.csv`` in both,
the two sweeps pass each point the same arguments and write the same
``results.csv``, pressures included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowstate_tpu.experiments import sweep as jax_sweep
from flowstate_tpu.io import aggregate as jax_aggregate
from flowstate_tpu_torch.experiments import single_run, sweep
from flowstate_tpu_torch.io import aggregate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(experiment_id="sw", density_start=0.03, density_end=0.04,
             density_intervals=2, equilibration_steps=100,
             production_steps=300, sampling_frequency=50,
             adjusting_frequency=100, num_chains=2,
             initialisation_type="low_left")


@pytest.mark.parametrize("header", ["t,rho,p,ar", ""])
def test_append_row_locked_writes_the_header_once(tmp_path, header):
    path = str(tmp_path / "results.csv")
    aggregate.append_row_locked(path, "1.0,0.03,0.1,1.0", header=header)
    aggregate.append_row_locked(path, "2.0,0.04,0.2,1.0", header=header)
    head = header + "\n" if header else ""
    assert open(path).read() == head + "1.0,0.03,0.1,1.0\n2.0,0.04,0.2,1.0\n"


def test_aggregator_concurrent_processes(tmp_path):
    """Many processes appending concurrently must not interleave rows."""
    path = str(tmp_path / "shared.csv")
    script = (
        "import sys; sys.path.insert(0, %r); "
        "from flowstate_tpu_torch.io.aggregate import append_row_locked; "
        "[append_row_locked(%r, f'{%d},{i}', header='proc,i') "
        "for i in range(50)]")
    procs = [subprocess.Popen([sys.executable, "-c", script % (REPO, path, p)])
             for p in range(4)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "proc,i"
    assert len(lines) == 1 + 4 * 50
    # every line is well-formed (no torn writes)
    for line in lines[1:]:
        a, b = line.split(",")
        assert 0 <= int(a) < 4 and 0 <= int(b) < 50


def test_append_results_matches_the_jax_package(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rng = np.random.default_rng(11)
    with open(run / "sampled_data.csv", "w") as f:
        f.write("cycle_number,energy_per_particle,density,pressure,"
                "box_size_x,box_size_y,particle_configuration\n")
        for i in range(1, 9):
            f.write(f"{100 + 50 * i},{rng.normal()},0.03,{rng.normal()},"
                    f"{10.0 + rng.random()},10.0,\"[0.0, 1.0]\"\n")
    mine = aggregate.append_results(str(tmp_path / "port.csv"), str(run),
                                    1.0, 200)
    ref = jax_aggregate.append_results(str(tmp_path / "jax.csv"), str(run),
                                       1.0, 200)
    assert mine == ref
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "jax.csv").read_text())
    assert len((tmp_path / "port.csv").read_text().splitlines()) == 2


def test_sweep_matches_the_jax_sweep(tmp_path):
    port_csv = sweep.run_experiments(
        sweep.SweepParams(output_path=str(tmp_path / "port"), **SMALL),
        device="cpu")
    jax_csv = jax_sweep.run_experiments(
        jax_sweep.SweepParams(output_path=str(tmp_path / "jax"), **SMALL))
    port_dir, jax_dir = os.path.dirname(port_csv), os.path.dirname(jax_csv)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert sorted(d for d in os.listdir(port_dir)
                  if os.path.isdir(os.path.join(port_dir, d))) == [
        "rho_0.0300_T_1.000_AR_1.00", "rho_0.0400_T_1.000_AR_1.00"]
    with open(os.path.join(port_dir, "parameters.json")) as f:
        mine = json.load(f)
    with open(os.path.join(jax_dir, "parameters.json")) as f:
        ref = json.load(f)
    assert mine.pop("output_path") == str(tmp_path / "port")
    assert ref.pop("output_path") == str(tmp_path / "jax")
    assert mine == ref

    lines = open(port_csv).read().strip().split("\n")
    assert lines[0] == open(jax_csv).read().split("\n")[0]
    assert len(lines) == 3
    rows = np.genfromtxt(port_csv, delimiter=",", skip_header=1)
    ref_rows = np.genfromtxt(jax_csv, delimiter=",", skip_header=1)
    for col in (0, 1, 3):       # temperature, density, aspect ratio
        np.testing.assert_allclose(rows[:, col], ref_rows[:, col], rtol=1e-6)
    np.testing.assert_allclose(rows[:, 1], [0.03, 0.04], rtol=1e-6)
    assert np.all(np.isfinite(rows[:, 2])) and np.all(
        np.isfinite(ref_rows[:, 2]))


def test_sweep_feeds_and_aggregates_each_point_as_the_jax_sweep(
        tmp_path, monkeypatch):
    """Each grid point's run replaced, in both packages, by one that records
    its arguments and writes a sampled_data.csv made from them: the same
    arguments reach every point, and results.csv is the same file."""
    from flowstate_tpu.experiments import single_run as jax_single_run

    calls = {"port": [], "jax": []}

    def fake_run(which):
        def run(argv):
            args = dict(zip(argv[::2], argv[1::2]))
            calls[which].append(argv)
            job = os.path.join(args["--output_path"], args["--experiment_id"])
            os.makedirs(job)
            rho, temp = float(args["--initial_rho"]), float(args["--temperature"])
            rng = np.random.default_rng(int(1e4 * rho + 10 * temp))
            with open(os.path.join(job, "sampled_data.csv"), "w") as f:
                f.write("cycle_number,energy_per_particle,density,pressure,"
                        "box_size_x,box_size_y,particle_configuration\n")
                for i in range(1, 9):
                    f.write(f"{50 * i},{rng.normal()},{rho},"
                            f"{rho * temp + rng.normal()},"
                            f"{10.0 + rng.random()},10.0,\"[0.0]\"\n")
        return run

    monkeypatch.setattr(single_run, "main", fake_run("port"))
    monkeypatch.setattr(jax_single_run, "main", fake_run("jax"))
    grid = {**SMALL, "temp_end": 1.5, "temp_intervals": 2,
            "equilibration_steps": 200}
    port_csv = sweep.run_experiments(
        sweep.SweepParams(output_path=str(tmp_path / "port"), **grid),
        device="cpu")
    jax_csv = jax_sweep.run_experiments(
        jax_sweep.SweepParams(output_path=str(tmp_path / "jax"), **grid))
    assert len(calls["port"]) == len(calls["jax"]) == 4
    for mine, ref in zip(calls["port"], calls["jax"]):
        assert mine[-2:] == ["--device", "cpu"]
        out = mine.index("--output_path") + 1
        assert mine[out] == os.path.dirname(port_csv)
        assert ref[out] == os.path.dirname(jax_csv)
        assert mine[:out] + mine[out + 1:-2] == ref[:out] + ref[out + 1:]
    text = open(port_csv).read()
    assert text == open(jax_csv).read()
    rows = np.genfromtxt(port_csv, delimiter=",", skip_header=1)
    assert rows.shape == (4, 4) and len(set(rows[:, 2])) == 4


def test_sweep_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_experiments(sweep.SweepParams(output_path=str(tmp_path),
                                                **SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main([])
    assert not any(tmp_path.iterdir())   # refused before writing anything


@pytest.mark.parametrize("matplotlib_present", [False, True])
def test_single_run_with_wells_with_and_without_matplotlib(
        tmp_path, monkeypatch, capsys, matplotlib_present):
    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    summary = single_run.main([
        "--temperature", "1.0", "--num_particles", "3",
        "--initial_rho", "0.03", "--equilibration_steps", "100",
        "--production_steps", "300", "--sampling_frequency", "50",
        "--adjusting_frequency", "100", "--output_path", str(tmp_path),
        "--experiment_id", "f1", "--num_wells", "2",
        "--V0_list", "-10.0", "-10.0", "--k", "15", "--r0", "1.2",
        "--initialisation_type", "low_left", "--seed", "3",
        "--initial_max_displacement", "0.65", "--num_chains", "2",
        "--device", "cpu", "--visualise"])
    out = tmp_path / "f1"
    assert np.load(out / "production_configs.npz")["configs"].shape == (
        2, 6, 3, 2)
    rows = np.genfromtxt(out / "sampled_data.csv", delimiter=",",
                         skip_header=1, usecols=(0, 1, 2, 3))
    assert rows.shape == (6, 4) and np.all(np.isfinite(rows))
    assert np.isfinite(summary["mean_pressure"])
    printed = capsys.readouterr().out
    figures = ("potential", "simulation_snapshots")
    for figure in figures:
        assert (out / f"{figure}.png").is_file() == matplotlib_present
        assert (f"{figure}.png/.svg not written: matplotlib cannot be "
                f"imported" in printed) != matplotlib_present
