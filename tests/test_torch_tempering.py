"""The port's parallel tempering against the JAX package.

* ``temperature_ladder``: equal to JAX's (float32, both kinds).
* ``swap_replicas`` on seeded (R, W) states with injected uniforms: bit
  for bit JAX's new positions, energies, virials, accept flags and edge
  flags, for both parities; the energy multiset of every walker kept.
* The plain engine with a (C,) beta: against JAX's ``_apply_move`` scan
  run per chain at its replica's beta, on the same injected tables
  (positions atol 1e-5, energies atol 1e-4, the near-tie rule of
  test_torch_metropolis.py); and bit-equal to runs at each scalar beta.
* ``well_counts_device``: equal to JAX's.
* ``run_replica_exchange`` from an all-in-A start: the cold marginal
  within 0.3 of the quadrature ΔF (the bound of tests/test_tempering.py).
* The driver at R=3, W=4 on the CPU: a run resumed after two of four
  segments bit-equal to an uninterrupted one, and the segment NPZ keys,
  dtypes and shapes, the evidence keys and the metrics events equal to
  the JAX driver's at the same size.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.analysis.wells import well_counts_device as jax_counts
from flowstate_tpu.experiments import tempering as jax_tempering
from flowstate_tpu.mcmc.metropolis import _apply_move
from flowstate_tpu.ops.potentials import double_well_potential
from flowstate_tpu.utils.config import tempering_config as jax_tempering_config
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.analysis.wells import well_counts_device
from flowstate_tpu_torch.experiments import tempering
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS
from flowstate_tpu_torch.utils.config import tempering_config

torch.set_num_threads(1)

NEAR_TIE = 1e-5
WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def specs(n, rho=0.03, **kw):
    kw = kw or WELLS
    return (jops.SystemSpec.create(n, jops.Box.from_density(n, rho), **kw),
            tops.SystemSpec.create(n, tops.Box.from_density(n, rho), **kw))


def test_temperature_ladder_equals_jax():
    for args in ((1.0, 10.0, 10, "geometric"), (1.0, 8.0, 4, "geometric"),
                 (1.0, 3.0, 3, "linear")):
        mine = tmcmc.temperature_ladder(*args, device="cpu")
        assert mine.dtype == torch.float32
        np.testing.assert_array_equal(
            mine.numpy(), np.asarray(jmcmc.temperature_ladder(*args)))
    for kind, r in (("geometric", 1), ("nope", 3)):
        with pytest.raises(ValueError):
            tmcmc.temperature_ladder(1.0, 2.0, r, kind, device="cpu")


def seeded_states(r, w, n, seed):
    """The same (R, W) tempered state in both packages, with energies and
    virials drawn so that some swaps pass and some do not."""
    jspec, tspec = specs(n)
    rng = np.random.default_rng(seed)
    lx = tspec.box.size_x
    pos = rng.uniform(0, lx, (r, w, n, 2)).astype(np.float32)
    energy = rng.normal(-25.0, 4.0, (r, w)).astype(np.float32)
    virial = rng.normal(0.0, 3.0, (r, w)).astype(np.float32)
    js = jmcmc.init_tempered_state(jspec, jnp.asarray(pos),
                                   jax.random.key(seed), 0.5)
    js = js._replace(energy=jnp.asarray(energy), virial=jnp.asarray(virial))
    ts = tmcmc.init_tempered_state(tspec, torch.as_tensor(pos), seed, 0.5)
    ts = ts.replace(energy=torch.as_tensor(energy).reshape(-1),
                    virial=torch.as_tensor(virial).reshape(-1))
    return js, ts


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_replicas_bit_equal_to_jax(parity):
    r, w, n = 5, 7, 3
    js, ts = seeded_states(r, w, n, 3 + parity)
    betas = np.array(jmcmc.temperature_ladder(1.0, 6.0, r))
    u = np.random.default_rng(9).random((r, w), dtype=np.float32)
    jres = jmcmc.swap_replicas(jnp.asarray(betas), js, None, parity,
                               u=jnp.asarray(u))
    tres = tmcmc.swap_replicas(torch.as_tensor(betas), ts, None, parity,
                               u=torch.as_tensor(u))
    acc = np.asarray(jres.accepted)
    assert 0 < acc.sum() < acc.size - w          # some pass, some do not
    np.testing.assert_array_equal(tres.accepted.numpy(), acc)
    np.testing.assert_array_equal(tres.edge_attempted.numpy(),
                                  np.asarray(jres.edge_attempted))
    view = tmcmc.replica_view(tres.state, r)
    for f in ("positions", "energy", "virial"):
        np.testing.assert_array_equal(getattr(view, f).numpy(),
                                      np.asarray(getattr(jres.state, f)))
    # the temperature's own fields stay; every walker's energies are kept
    for f in ("max_disp", "attempts", "accepts"):
        assert torch.equal(getattr(tres.state, f), getattr(ts, f))
    np.testing.assert_array_equal(
        np.sort(view.energy.numpy(), axis=0),
        np.sort(ts.energy.reshape(r, w).numpy(), axis=0))
    # the edges of this parity: (0,1), (2,3) or (1,2), (3,4)
    np.testing.assert_array_equal(
        tres.edge_attempted.numpy()[:-1],
        [(i - parity) % 2 == 0 for i in range(r - 1)])


def test_plain_engine_with_beta_per_chain_matches_jax():
    check_plain_engine_with_beta_per_chain(3)


def test_plain_engine_with_beta_per_chain_matches_jax_at_n8():
    """N=8, the width of the PT runs held against ``pt_n8_r5``."""
    check_plain_engine_with_beta_per_chain(8)


def check_plain_engine_with_beta_per_chain(n):
    """The plain engine with a (C,) beta against JAX's ``_apply_move``
    scanned at each chain's beta under injected tables (positions 1e-5,
    energies 1e-4, decisions equal but at a near tie), and bit-equal to
    runs of each replica's rows at its scalar beta."""
    r, w, moves = 3, 6, 120
    jspec, tspec = specs(n)
    pos, _ = jmcmc.init_alternating_wells(w, n, 0.03)
    pos = np.broadcast_to(pos, (r, w, n, 2)).astype(np.float32)
    betas = np.array(jmcmc.temperature_ladder(1.0, 10.0, r))
    rng = np.random.default_rng(5)
    c = r * w
    tabs = (rng.integers(0, n, (c, moves)).astype(np.int32),
            rng.random((c, moves, 2), dtype=np.float32),
            rng.random((c, moves), dtype=np.float32))
    ts = tmcmc.init_tempered_state(tspec, torch.as_tensor(pos), 0, 1.2)
    beta_c = tmcmc.chain_betas(torch.as_tensor(betas), w)
    margins = torch.empty((c, moves))
    out = cm.run_moves_plain(tspec, beta_c, ts,
                             moves, tuple(torch.as_tensor(t) for t in tabs),
                             margins)

    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos.reshape(c, n, 2)),
                                jax.random.key(0), 1.2)

    @jax.jit
    def scan_one(s, b, p, d, u):
        def body(s, xs):
            s2 = _apply_move(jspec, b, s, *xs)
            return s2, s2.accepts > s.accepts
        return jax.lax.scan(body, s, (p, d, u))

    jout, jacc = jax.vmap(scan_one)(js, jnp.asarray(beta_c.numpy()),
                                    *(jnp.asarray(t) for t in tabs))
    differ = np.asarray(jacc) != (margins.numpy() > 0)
    split = differ.any(axis=1)
    first = differ.argmax(axis=1)
    assert np.all(np.abs(margins.numpy()[split, first[split]]) < NEAR_TIE)
    assert split.sum() <= 1
    keep = ~split
    np.testing.assert_allclose(out.positions.numpy()[keep],
                               np.asarray(jout.positions)[keep], atol=1e-5)
    np.testing.assert_allclose(out.energy.numpy()[keep],
                               np.asarray(jout.energy)[keep], atol=1e-4)
    np.testing.assert_array_equal(out.accepts.numpy()[keep],
                                  np.asarray(jout.accepts)[keep])
    # the hot replicas accept more than the cold one
    acc = (out.accepts.reshape(r, w).float().mean(1)).numpy()
    assert acc[0] < acc[-1]

    # the (C,) beta gives, chain by chain, what a run at that beta gives
    for i, b in enumerate(betas):
        rows = slice(i * w, (i + 1) * w)
        sub = ts.replace(**{f: getattr(ts, f)[rows] for f in TENSOR_FIELDS})
        alone = cm.run_moves_plain(
            tspec, float(b), sub, moves,
            tuple(torch.as_tensor(t[rows]) for t in tabs))
        assert torch.equal(alone.positions, out.positions[rows])
        assert torch.equal(alone.energy, out.energy[rows])
        assert torch.equal(alone.accepts, out.accepts[rows])
    with pytest.raises(ValueError):
        cm.run_moves_plain(tspec, beta_c[:-1], ts, 1)


def test_well_counts_device_equals_jax():
    rng = np.random.default_rng(2)
    hb = 5.0
    # positions near the circles' edges and across the box's edges
    pos = rng.uniform(-1.0, 2 * hb + 1.0, (4, 6, 5, 2)).astype(np.float32)
    pos[0, :, :, 0] = 2.5 + rng.uniform(-1.4, 1.4, (6, 5))
    pos[0, :, :, 1] = 5.0
    mine = well_counts_device(torch.as_tensor(pos), hb, 1.2)
    ref = jax_counts(jnp.asarray(pos), hb, 1.2)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(mine[0].sum()) > 0 and int(mine[1].sum()) > 0


def test_replica_exchange_cold_marginal_matches_quadrature():
    """Every walker starts in well A; the cold marginal of a 4-replica
    ladder must still find the exact occupancy ratio of a deep N=1
    double well."""
    kw = dict(num_wells=2, V0_list=(-6.0, -6.5), r0=1.2, k=15.0)
    jspec, spec = specs(1, rho=0.01, **kw)
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    v = np.asarray(double_well_potential(
        jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1)), lx, ly,
        V0_list=list(spec.V0_list), r0=spec.r0, k=spec.k)).reshape(g, g)
    wgt = np.exp(-v)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    in_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact = np.log(wgt[in_b].sum() / wgt[in_a].sum())

    r, w = 4, 64
    betas = tmcmc.temperature_ladder(1.0, 6.0, r, device="cpu")
    pos = torch.tensor([lx / 4, ly / 2]).repeat(r, w, 1, 1)
    state = tmcmc.init_tempered_state(spec, pos, 5, 1.5)
    gen = torch.Generator().manual_seed(6)
    res = tmcmc.run_replica_exchange(spec, betas, state, gen, 400, 25)
    assert bool((res.edge_acceptance > 0.05).all()), res.edge_acceptance
    assert res.cold_positions.shape == (400, w, 1, 2)
    xy = res.cold_positions[200:].reshape(-1, 2).numpy()
    sa = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    sb = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    assert sb.sum() > 0, "the cold replica never reached well B"
    sampled = np.log(sb.sum() / sa.sum())
    assert abs(sampled - exact) < 0.3, (sampled, exact)
    # record='all' keeps every replica; record_fn's outputs are stacked
    res = tmcmc.run_replica_exchange(
        spec, betas, res.state, gen, 3, 5, record="all",
        record_fn=lambda v: (v.energy * 2, v.max_disp))
    assert res.cold_positions.shape == (3, r, w, 1, 2)
    assert res.cold_energy.shape == (3, r, w)
    assert torch.equal(res.extras[0][-1], 2 * res.cold_energy[-1])


DRIVER = dict(num_chains=4, pt_replicas=3, pt_moves_per_round=20,
              pt_segment_rounds=5, equilibration_steps=100,
              adjusting_frequency=50)
STEPS = 4 * 20 * 20      # 20 rounds: 4 segments of 5


def test_driver_resume_bit_equal_and_files_like_jax(tmp_path):
    straight = tempering.run(
        tempering_config(experiment_id="pt", output_dir=str(tmp_path / "a"),
                         **DRIVER), STEPS, device="cpu")
    cfg = tempering_config(experiment_id="pt",
                           output_dir=str(tmp_path / "b"), **DRIVER)
    part = tempering.run(cfg, STEPS // 2, device="cpu")
    assert part["rounds"] == 10 and len(part["segment_s"]) == 2
    resumed = tempering.run(cfg, STEPS, resume=True, device="cpu")
    assert len(resumed["segment_s"]) == 2 and resumed["rounds"] == 20
    for f in TENSOR_FIELDS:       # bit for bit, the NaN virial too
        a, b = getattr(resumed["state"], f), getattr(straight["state"], f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f
    assert resumed["state"].calls == straight["state"].calls
    da, db = tmp_path / "a" / "pt", tmp_path / "b" / "pt"
    names = sorted(p.name for p in (da / "segments").iterdir())
    assert names == [f"seg_{i:04d}.npz" for i in range(4)]
    for name in names:
        a, b = np.load(da / "segments" / name), np.load(db / "segments" / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for k in ("df_particle_mbar", "df_particle_cold", "delta_f_mean"):
        assert resumed[k] == straight[k]
    assert all(np.isfinite(straight["energy_drift"]))
    assert max(straight["energy_drift"]) < 1e-3

    # the JAX driver at the same size writes the same files
    jcfg = jax_tempering_config(experiment_id="pt",
                                output_dir=str(tmp_path / "jax"), **DRIVER)
    jax_tempering.run(jcfg, STEPS // 2)
    dj = tmp_path / "jax" / "pt"
    for name in ("seg_0000.npz", "seg_0001.npz"):
        a, b = np.load(da / "segments" / name), np.load(dj / "segments" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    ev = json.loads((tmp_path / "a" / "evidence" / "pt_data.json").read_text())
    jev = json.loads((tmp_path / "jax" / "evidence" / "pt_data.json")
                     .read_text())
    assert set(ev) == set(jev)
    assert set(ev["sector_counts"]) == set(jev["sector_counts"])
    # the port counts every walker's second half of the rounds (R9: the
    # JAX driver's counts drop half the walkers after a third of rounds)
    counts = ev["sector_counts"]
    assert sum(v for k, v in counts.items() if k != "burn_frac") == 4 * 10
    jcounts = jev["sector_counts"]
    assert sum(v for k, v in jcounts.items() if k != "burn_frac") == (
        (10 - 10 // 3) * (4 - 4 // 2))
    assert ev["ladder"]["betas"] == jev["ladder"]["betas"]

    def events(d):
        return [json.loads(line)["event"]
                for line in (d / "metrics.jsonl").read_text().splitlines()]

    assert events(da) == events(dj)[:1] + ["segment_done"] * 4 + [
        "free_energy"]
    written = {str(p.relative_to(da)) for p in da.rglob("*_data.json")}
    assert written == {str(p.relative_to(dj)) for p in dj.rglob("*_data.json")}


@pytest.mark.parametrize("n", [3, 8])
def test_tempering_check_runs_on_the_cpu(tmp_path, n):
    """The tool at a CPU's size: its JSON line and evidence file, the JAX
    numbers beside the port's, no TEMPERING.md written."""
    from flowstate_tpu_torch.tools import tempering_check

    evidence = tmp_path / "check.json"
    line = tempering_check.main([
        "--device", "cpu", "--num_particles", str(n), "--walkers", "6",
        "--replicas", "3", "--rounds", "30", "--moves_per_round", "10",
        "--evidence", str(evidence)])
    assert json.loads(evidence.read_text())["rounds"] == 30
    # N=3 starts all in A with none, as the JAX tool; N=8 as the driver
    assert line["equilibration_steps"] == (0 if n == 3 else 5000)
    assert line["jax"] == tempering_check.JAX_REFERENCE[n]
    assert len(line["edge_acceptance"]) == 2
    assert line["mbar_pooled_samples"] == 3 * 20 * 6
    assert line["cold_frames_used"] == 20 * 6
    assert sum(line["sector_fracs"].values()) == pytest.approx(1.0, abs=1e-3)
    assert np.isfinite(line["df_particle_mbar"])
    assert not (tmp_path / "TEMPERING.md").exists()
