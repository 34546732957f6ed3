"""The port's NVT single-run CLI (``flowstate_tpu_torch.experiments.
single_run``) against the JAX package's.

First the CLI end to end on the CPU, with the arguments of
tests/test_io_and_cli.py::test_single_run_cli plus ``--device cpu``: the
same artefacts and the same summary keys as the JAX CLI.

Then the CLI's schedule pathwise: ``single_run.main`` at N = 64, C = 4 with
its move segments fed numpy random tables (``run_moves_plain``), against
the JAX engine's ``_apply_move`` scanned over the same tables in the JAX
CLI's schedule (equilibration blocks with ``adjust_displacement``, then
production blocks sampled on the tracked state).  Positions atol 1e-5 and
accepts exact, with the near-tie rule of test_torch_metropolis.py.  The
port resyncs energy and virial before every sample and the JAX CLI tracks
them move by move, so energies per particle and pressures may differ by
the JAX engine's float32 drift over at most 600 moves: bound atol 1e-5
(E/N of order 1, pressure of order 0.1; the drift seen is 4.8e-7 in E/N
and 6e-8 in pressure).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.experiments import single_run as jax_single_run
from flowstate_tpu.mcmc.metropolis import _apply_move
from flowstate_tpu_torch.experiments import single_run
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.ops import cuda_pair

torch.set_num_threads(1)

NEAR_TIE = 1e-5
CLI_TEST_ARGS = [
    "--temperature", "1.0", "--num_particles", "3",
    "--initial_rho", "0.03", "--equilibration_steps", "300",
    "--production_steps", "600", "--sampling_frequency", "50",
    "--adjusting_frequency", "100", "--experiment_id", "cli_test",
    "--num_wells", "2", "--V0_list", "-10.0", "-10.5", "--k", "15",
    "--r0", "1.2", "--initialisation_type", "low_left", "--seed", "7",
    "--initial_max_displacement", "0.65", "--num_chains", "4",
    "--visualise",
]


def test_single_run_cli_on_cpu_matches_the_jax_cli_outputs(tmp_path):
    k1, k2 = cm.LAUNCHES, cuda_pair.LAUNCHES
    summary = single_run.main(CLI_TEST_ARGS + [
        "--output_path", str(tmp_path / "port"), "--device", "cpu"])
    assert (cm.LAUNCHES, cuda_pair.LAUNCHES) == (k1, k2)
    assert 0.1 < summary["acceptance_fraction"] < 0.99
    out = tmp_path / "port" / "cli_test"
    npz = np.load(out / "production_configs.npz")
    assert npz["configs"].shape == (4, 12, 3, 2)
    assert np.all(np.abs(npz["configs"]) <= 5.0 + 1e-5)  # centered frame
    for f in ("sampled_data.csv", "simulation_snapshots.png",
              "potential.png"):
        assert (out / f).is_file(), f
    rows = np.genfromtxt(out / "sampled_data.csv", delimiter=",",
                         skip_header=1, usecols=(0, 1, 2, 3))
    np.testing.assert_array_equal(rows[:, 0], 300 + 50 * np.arange(1, 13))
    assert np.all(np.isfinite(rows))
    np.testing.assert_allclose(rows[:, 2], 0.03, rtol=1e-6)
    assert summary["samples_per_chain"] == 12
    assert np.isfinite(summary["mean_pressure"])

    reference = jax_single_run.main(CLI_TEST_ARGS + [
        "--output_path", str(tmp_path / "jax")])
    assert set(summary) == set(reference)
    assert summary["output_dir"] == str(out)


def test_single_run_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_run.main(CLI_TEST_ARGS + ["--output_path", str(tmp_path)])
    assert not any(tmp_path.iterdir())   # refused before writing anything


def test_single_run_schedule_pathwise_matches_jax(tmp_path, monkeypatch):
    n, c, rho, beta = 64, 4, 0.3, 1.0
    eq, adjust, prod, every = 200, 100, 400, 50
    rng = np.random.default_rng(64)
    blocks = [(rng.integers(0, n, (c, m)).astype(np.int32),
               rng.random((c, m, 2), dtype=np.float32),
               rng.random((c, m), dtype=np.float32))
              for m in [adjust] * (eq // adjust) + [every] * (prod // every)]

    # port: the CLI itself, its move segments fed the tables
    feed, margins = iter(blocks), []

    def fed_moves(spec, b, s, m):
        tab = tuple(torch.as_tensor(a) for a in next(feed))
        assert tab[0].shape == (c, m) and b == beta
        margins.append(torch.empty((c, m)))
        return cm.run_moves_plain(spec, b, s, m, tab, margins[-1])

    monkeypatch.setattr(single_run, "run_moves_auto", fed_moves)
    monkeypatch.setattr(cm, "run_moves_auto", fed_moves)
    summary = single_run.main([
        "--temperature", "1.0", "--num_particles", str(n),
        "--initial_rho", str(rho), "--equilibration_steps", str(eq),
        "--production_steps", str(prod), "--sampling_frequency", str(every),
        "--adjusting_frequency", str(adjust), "--output_path", str(tmp_path),
        "--experiment_id", "path", "--seed", "3", "--num_chains", str(c),
        "--initial_max_displacement", "0.8", "--device", "cpu"])
    assert next(feed, None) is None

    # JAX: the JAX CLI's schedule over the same tables
    lattice, box = jmcmc.initialise_fcc(n, rho, 1.0)
    jspec = jops.SystemSpec.create(n, box)
    js = jmcmc.init_chain_state(
        jspec, jnp.asarray(np.tile(lattice[None], (c, 1, 1))),
        jax.random.key(3), 0.8)

    @jax.jit
    def jax_block(s, p, d, u):
        def one_chain(s, p, d, u):
            def body(s, xs):
                s2 = _apply_move(jspec, beta, s, *xs)
                return s2, s2.accepts > s.accepts
            return jax.lax.scan(body, s, (p, d, u))
        return jax.vmap(one_chain)(s, p, d, u)

    j_acc, j_obs = [], []
    for i, tab in enumerate(blocks):
        js, acc = jax_block(js, *(jnp.asarray(a) for a in tab))
        j_acc.append(np.asarray(acc))
        if i < eq // adjust:
            js = jmcmc.adjust_displacement(js)
        else:
            j_obs.append(jmcmc.sample_observables(
                jspec, beta, js, eq + (i - eq // adjust + 1) * every))

    ref = np.concatenate(j_acc, axis=1)
    mine = np.concatenate([m.numpy() for m in margins], axis=1)
    differ = ref != (mine > 0)
    split = differ.any(axis=1)
    first = differ.argmax(axis=1)
    assert np.all(np.abs(mine[split, first[split]]) < NEAR_TIE)
    assert split.sum() <= 1
    keep = ~split
    # these tables hold no near tie: chain 0 (the CSV) and the summary,
    # over all chains, compare too
    assert keep.all()

    out = tmp_path / "path"
    configs = np.load(out / "production_configs.npz")["configs"]
    half = np.array([box.size_x / 2.0, box.size_y / 2.0])
    j_pos = np.stack([np.asarray(o.positions) for o in j_obs], axis=1)
    np.testing.assert_allclose(configs[keep] + half, j_pos[keep], atol=1e-5)
    rows = np.genfromtxt(out / "sampled_data.csv", delimiter=",",
                         skip_header=1, usecols=(0, 1, 2, 3))
    np.testing.assert_array_equal(rows[:, 0], [int(o.cycle) for o in j_obs])
    for col, key in ((1, "energy_per_particle"), (3, "pressure")):
        np.testing.assert_allclose(
            rows[:, col], [float(getattr(o, key)[0]) for o in j_obs],
            atol=1e-5)
    np.testing.assert_allclose(rows[:, 2], n / box.volume, rtol=1e-6)
    attempts = int(np.sum(np.asarray(js.attempts)))
    accepts = int(np.sum(np.asarray(js.accepts)))
    assert summary["acceptance_fraction"] == accepts / attempts
    for key in ("energy_per_particle", "pressure"):
        np.testing.assert_allclose(
            summary[f"mean_{key}"],
            np.mean([np.asarray(getattr(o, key)) for o in j_obs]), atol=1e-5)
    np.testing.assert_allclose(summary["final_max_displacement"],
                               float(np.mean(np.asarray(js.max_disp))),
                               rtol=1e-6)
    assert summary["samples_per_chain"] == prod // every
