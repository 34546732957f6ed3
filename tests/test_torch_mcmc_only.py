"""The port's MCMC-only slice as a whole, against the JAX package.

Pathwise: equilibration blocks, ``adjust_displacement``, production blocks
(moves, ``resync_energy``, ``sample_observables``) driven by the same numpy
random tables through ``flowstate_tpu`` and ``flowstate_tpu_torch``.
Tolerances as in test_torch_metropolis.py: positions atol 1e-5, energies
and pressures atol 1e-4, accepts exact, with the near-tie rule.

Then the experiment end to end on the CPU, the port's import hygiene, and
``chip_smoke.py``'s refusal to run without a card.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.mcmc.metropolis import _apply_move
from flowstate_tpu.utils.config import mcmc_only_config as jax_mcmc_only_config
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.experiments import mcmc_only
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.utils.config import mcmc_only_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 1e-5


def test_slice_pathwise_matches_jax():
    n, c, beta = 3, 16, 1.0
    kw = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    jspec = jops.SystemSpec.create(n, jops.Box.from_density(n, 0.03), **kw)
    tspec = tops.SystemSpec.create(n, tops.Box.from_density(n, 0.03), **kw)
    pos, _ = jmcmc.init_alternating_wells(c, n, 0.03)
    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos), jax.random.key(0), 0.65)
    ts = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0, 0.65)

    rng = np.random.default_rng(42)
    eq_blocks, eq_len, samples, stride = 2, 100, 5, 50
    blocks = [(rng.integers(0, n, (c, m)).astype(np.int32),
               rng.random((c, m, 2), dtype=np.float32),
               rng.random((c, m), dtype=np.float32))
              for m in [eq_len] * eq_blocks + [stride] * samples]

    @jax.jit
    def jax_block(s, p, d, u):
        def one_chain(s, p, d, u):
            def body(s, xs):
                s2 = _apply_move(jspec, beta, s, *xs)
                return s2, s2.accepts > s.accepts
            return jax.lax.scan(body, s, (p, d, u))
        return jax.vmap(one_chain)(s, p, d, u)

    # JAX: equilibration with adaptation, then production blocks that
    # resync before sampling (the port's run_production_kernel schedule)
    j_acc, j_obs = [], []
    for i, tab in enumerate(blocks):
        js, acc = jax_block(js, *(jnp.asarray(a) for a in tab))
        j_acc.append(np.asarray(acc))
        if i < eq_blocks:
            js = jmcmc.adjust_displacement(js)
        else:
            js = jmcmc.resync_energy(jspec, js)
            j_obs.append(jmcmc.sample_observables(
                jspec, beta, js, (i - eq_blocks + 1) * stride))

    # port: the same schedule through the functions its experiments call,
    # the move segments through run_moves_plain fed the same tables
    margins = []
    feed = iter(blocks)

    def move_fn(s, m):
        tab = tuple(torch.as_tensor(a) for a in next(feed))
        margins.append(torch.empty((c, m)))
        return cm.run_moves_plain(tspec, beta, s, m, tab, margins[-1])

    ts = tmcmc.run_equilibration(tspec, beta, ts, eq_blocks * eq_len, eq_len,
                                 move_fn=move_fn)
    ts, obs = tmcmc.run_production_with(
        tspec, beta, ts, samples, stride,
        lambda s, m: tmcmc.resync_energy(tspec, move_fn(s, m)))

    ref = np.concatenate(j_acc, axis=1)
    mine = np.concatenate([m.numpy() for m in margins], axis=1)
    differ = ref != (mine > 0)
    split = differ.any(axis=1)
    first = differ.argmax(axis=1)
    assert np.all(np.abs(mine[split, first[split]]) < NEAR_TIE)
    assert split.sum() <= 1
    keep = ~split

    jo = {k: np.stack([np.asarray(getattr(o, k)) for o in j_obs], axis=1)
          for k in ("energy_per_particle", "pressure", "density",
                    "positions")}
    np.testing.assert_array_equal(
        obs.cycle.numpy(),
        np.broadcast_to([int(o.cycle) for o in j_obs], (c, samples)))
    np.testing.assert_allclose(obs.positions.numpy()[keep],
                               jo["positions"][keep], atol=1e-5)
    for k in ("energy_per_particle", "pressure", "density"):
        np.testing.assert_allclose(getattr(obs, k).numpy()[keep], jo[k][keep],
                                   atol=1e-4)
    np.testing.assert_allclose(ts.max_disp.numpy(), np.asarray(js.max_disp),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.accepts.numpy()[keep],
                                  np.asarray(js.accepts)[keep])


def test_mcmc_only_experiment_on_cpu(tmp_path):
    cfg = mcmc_only_config(experiment_id="port", num_chains=8,
                           equilibration_steps=2000, output_dir=str(tmp_path))
    out = mcmc_only.run(cfg, total_production_steps=60_000, device="cpu")
    d = tmp_path / "port"
    for f in ("params.json", "experiment.log", "metrics.jsonl"):
        assert (d / f).is_file(), f
    for i in range(1, 9):
        run = d / "mc_runs" / f"run_{i:03d}"
        assert (run / "sampled_data.csv").is_file()
        configs = np.load(run / "mc_run_configs.npy")
        assert configs.shape == (50, 3, 2)
    rows = np.genfromtxt(d / "mc_runs" / "run_001" / "sampled_data.csv",
                         delimiter=",", skip_header=1, usecols=(0, 1, 3))
    np.testing.assert_array_equal(rows[:, 0], np.arange(1, 51) * 150)
    assert np.all(np.isfinite(rows))
    evidence = json.loads((tmp_path / "evidence" / "port_data.json").read_text())
    assert evidence["device"] == "cpu"
    assert np.isfinite(out["delta_f_mean"]) and np.isfinite(out["delta_f_sem"])
    assert 0.2 < out["production_acceptance"] < 0.98
    assert out["samples_per_chain"] == 50
    params = json.loads((d / "params.json").read_text())
    assert set(params) == set(jax_mcmc_only_config().to_dict())
    events = [json.loads(line)["event"]
              for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert events == ["equilibrated", "production_done", "free_energy"]
    # the JAX driver's *_data.json set (flowstate_tpu/experiments/
    # mcmc_only.py:119-135): per-run dumps for the first ten runs, then the
    # multi-run <x>, the mean free energy and the state histogram
    expected = {"avg_free_energy_data.json", "state_histogram_data.json",
                "multi_avg_x_data.json"}
    for i in range(1, 9):
        expected |= {f"mc_runs/run_{i:03d}/well_statistics_data.json",
                     f"mc_runs/run_{i:03d}/avg_x_coordinate_run_{i}_data.json"}
    written = {str(p.relative_to(d)) for p in d.rglob("*_data.json")}
    assert written == expected
    free = json.loads((d / "avg_free_energy_data.json").read_text())
    assert free["final_mean"] == out["delta_f_mean"]
    assert len(free["mean"]) == 50
    assert sum(json.loads((d / "state_histogram_data.json").read_text())
               ["state_counts"].values()) == 8 * 50


def test_unported_samplers_name_their_roadmap_item(tmp_path):
    """Once the samplers this ROADMAP item named (queue 1 item 11: MALA,
    HMC, PT) were refused; now each runs through ``mcmc_only.run`` on the
    CPU at a small size and writes the JAX driver's evidence keys."""
    metropolis_keys = None
    for sampler in ("metropolis", "mala", "hmc", "pt"):
        cfg = mcmc_only_config(
            experiment_id=sampler, sampler=sampler, num_chains=4,
            equilibration_steps=200, adjusting_frequency=100,
            pt_replicas=3, pt_moves_per_round=20, pt_segment_rounds=5,
            output_dir=str(tmp_path))
        steps = 4 * 20 * 10 if sampler == "pt" else 4 * 150 * 2
        out = mcmc_only.run(cfg, steps, device="cpu")
        ev = json.loads((tmp_path / "evidence" / f"{sampler}_data.json")
                        .read_text())
        assert ev["sampler"] == sampler and ev["device"] == "cpu"
        if sampler == "pt":
            assert ev["driver"] == "tempering" and out["rounds"] == 10
            assert {"df_particle_mbar", "df_particle_mbar_sem",
                    "df_sector_mbar", "mbar_f_k", "edge_acceptance",
                    "ladder", "sector_counts"} <= set(ev)
            assert len(ev["edge_acceptance"]) == 2
            assert np.isfinite(out["df_particle_mbar"])
            continue
        if metropolis_keys is None:
            metropolis_keys = set(ev)
        assert set(ev) == metropolis_keys
        assert ev["driver"] == "mcmc_only" and out["samples_per_chain"] == 2
        assert 0.0 < out["production_acceptance"] < 1.0
        assert np.isfinite(out["energy_per_particle"])
        rows = np.genfromtxt(tmp_path / sampler / "mc_runs" / "run_001" /
                             "sampled_data.csv", delimiter=",",
                             skip_header=1, usecols=(1, 3))
        assert rows.shape == (2, 2) and np.isfinite(rows).all()
    events = [json.loads(line)["event"] for line in
              (tmp_path / "hmc" / "metrics.jsonl").read_text().splitlines()]
    assert events == ["equilibrated", "hmc_adapted", "production_done",
                      "free_energy"]


def test_port_imports_no_jax_flowstate_tpu_or_matplotlib():
    code = ("import sys, flowstate_tpu_torch.experiments.mcmc_only, "
            "flowstate_tpu_torch.experiments.single_run, "
            "flowstate_tpu_torch.analysis.plots, "
            "flowstate_tpu_torch.ops.cuda_pair, "
            "flowstate_tpu_torch.kernels.build, "
            "flowstate_tpu_torch.tools.n_scaling, "
            "flowstate_tpu_torch.io.aggregate, "
            "flowstate_tpu_torch.experiments.sweep, "
            "flowstate_tpu_torch.experiments.algorithm1, "
            "flowstate_tpu_torch.flows, flowstate_tpu_torch.training, "
            "flowstate_tpu_torch.mcmc.hybrid, "
            "flowstate_tpu_torch.analysis.rdf, "
            "flowstate_tpu_torch.flows.targets, "
            "flowstate_tpu_torch.training.cycles, "
            "flowstate_tpu_torch.utils.checkpoint, "
            "flowstate_tpu_torch.experiments.algorithm2, "
            "flowstate_tpu_torch.tools.a2_recipe, "
            "flowstate_tpu_torch.experiments.tempering, "
            "flowstate_tpu_torch.analysis.mbar, "
            "flowstate_tpu_torch.mcmc.tempering, "
            "flowstate_tpu_torch.mcmc.mala, flowstate_tpu_torch.mcmc.hmc, "
            "flowstate_tpu_torch.experiments.train_npz, "
            "flowstate_tpu_torch.tools.tempering_check, "
            "flowstate_tpu_torch.parallel, flowstate_tpu_torch.parallel.mesh, "
            "flowstate_tpu_torch.parallel.launch, flowstate_tpu_torch.entry, "
            "flowstate_tpu_torch.flows.affine, "
            "flowstate_tpu_torch.flows.autoregressive, "
            "flowstate_tpu_torch.flows.base, "
            "flowstate_tpu_torch.flows.distributions, "
            "flowstate_tpu_torch.flows.elementary, "
            "flowstate_tpu_torch.flows.image, "
            "flowstate_tpu_torch.flows.lipschitz, "
            "flowstate_tpu_torch.flows.mixing, "
            "flowstate_tpu_torch.flows.models, "
            "flowstate_tpu_torch.flows.normalization, "
            "flowstate_tpu_torch.flows.periodic, "
            "flowstate_tpu_torch.flows.reshape, "
            "flowstate_tpu_torch.flows.residual, "
            "flowstate_tpu_torch.flows.sampling, "
            "flowstate_tpu_torch.flows.stochastic, "
            "flowstate_tpu_torch.flows.toy_targets, "
            "flowstate_tpu_torch.flows.transforms, "
            "flowstate_tpu_torch.flows.utils, flowstate_tpu_torch.flows.vae, "
            "flowstate_tpu_torch.tools.common, "
            "flowstate_tpu_torch.tools.exact_free_energy, "
            "flowstate_tpu_torch.tools.sector_check, "
            "flowstate_tpu_torch.tools.move_kernel_check, "
            "flowstate_tpu_torch.tools.ess_check, "
            "flowstate_tpu_torch.tools.pt_mbar_oracle, "
            "flowstate_tpu_torch.tools.sampler_bench, "
            "flowstate_tpu_torch.tools.within_well_bench, "
            "flowstate_tpu_torch.tools.hybrid_n_scaling, "
            "flowstate_tpu_torch.tools.n_mitigation, "
            "flowstate_tpu_torch.tools.blocked_wall, "
            "flowstate_tpu_torch.tools.blocked_depth, "
            "flowstate_tpu_torch.tools.alpha_study, "
            "flowstate_tpu_torch.tools.make_notebooks, "
            "flowstate_tpu_torch.utils.roofs, "
            "flowstate_tpu_torch.tools.dp_measure, "
            "flowstate_tpu_torch.tools.train_roofline, "
            "flowstate_tpu_torch.tools.scaling_check, "
            "flowstate_tpu_torch.demos, flowstate_tpu_torch.demos.mcmc_demo, "
            "flowstate_tpu_torch.demos.hybrid_algorithm_1_demo, "
            "flowstate_tpu_torch.demos.hybrid_algorithm_2_demo, "
            "flowstate_tpu_torch.demos.nf_demo, "
            "flowstate_tpu_torch.demos.tempering_demo; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flowstate_tpu', 'matplotlib'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
