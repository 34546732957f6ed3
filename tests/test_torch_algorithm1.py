"""The port's big moves (``flowstate_tpu_torch.mcmc.hybrid``) and the
Algorithm 1 driver against the JAX package's.

``apply_big_moves`` runs on the same chain state, proposals, ``log_q_new``,
flow weights and uniforms in both (float32, as the drivers run): the MH
log-ratios are held to 1e-4 absolute, and the accept decisions agree
except where ``|exp(ratio_log) - u|`` is within ``NEAR_TIE`` (ROADMAP R2:
the two round differently).  The driver at the JAX smoke test's size
writes the JAX driver's files and evidence keys.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.flows.core import build_circular_flow as j_build_flow
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.analysis import plots as tplots
from flowstate_tpu_torch.experiments import algorithm1
from flowstate_tpu_torch.flows import build_circular_flow, params_from_jax
from flowstate_tpu_torch.utils.config import algorithm1_config

from test_torch_flow import random_tree

torch.set_num_threads(1)

N, C, RHO = 3, 64, 0.03
NEAR_TIE = 1e-4
WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def systems():
    jspec = jops.SystemSpec.create(N, jops.Box.from_density(N, RHO), **WELLS)
    tspec = tops.SystemSpec.create(N, tops.Box.from_density(N, RHO), **WELLS)
    return jspec, tspec


def big_move_inputs(seed):
    """Chain states near the wells, proposals jittered from them (so the
    energy changes are of order one and the decisions mixed), one
    proposal with two particles on top of each other, and uniforms."""
    rng = np.random.default_rng(seed)
    jspec, tspec = systems()
    pos, _ = jmcmc.init_alternating_wells(C, N, RHO)
    pos = np.asarray(pos, dtype=np.float32)
    box = tspec.box.size_x
    props = np.mod(pos + rng.normal(0.0, 0.35, pos.shape), box)
    props = props.astype(np.float32)
    props[5, 1] = props[5, 0]                        # overlap: U = +inf
    u = rng.random(C).astype(np.float32)
    return jspec, tspec, pos, props, u


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_big_moves_matches_jax(seed):
    jspec, tspec, pos, props, u = big_move_inputs(seed)
    half_box = tspec.box.size_x / 2.0
    jm = j_build_flow(N, 2, half_box, K=2, hidden_units=16, num_bins=4)
    tree = random_tree(jm.init_params(jax.random.key(0)), 300 + seed, 0.2)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tm = params_from_jax(tree, build_circular_flow(
        N, 2, half_box, K=2, hidden_units=16, num_bins=4, device="cpu"))
    jstate = jmcmc.init_chain_state(jspec, jnp.asarray(pos),
                                    jax.random.key(1), 0.65)
    tstate = tmcmc.chain_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()
         if k != "key"}, 0, "cpu")
    flat = (props - half_box).reshape(C, -1)
    log_q_new = np.asarray(jm.log_prob(jp, jnp.asarray(flat))) - 0.5

    jres = jmcmc.apply_big_moves(jspec, 1.0, jstate, jnp.asarray(props),
                                 jnp.asarray(log_q_new), jm, jp, half_box,
                                 jnp.asarray(u))
    tres = tmcmc.apply_big_moves(tspec, 1.0, tstate, torch.as_tensor(props),
                                 torch.as_tensor(log_q_new), tm, half_box,
                                 torch.as_tensor(u))
    j_ratio = np.asarray(jres.ratio_log)
    t_ratio = tres.ratio_log.numpy()
    assert np.isneginf(t_ratio[5]) and np.isneginf(j_ratio[5])
    finite = np.isfinite(j_ratio)
    np.testing.assert_array_equal(np.isfinite(t_ratio), finite)
    np.testing.assert_allclose(t_ratio[finite], j_ratio[finite], rtol=1e-5,
                               atol=1e-4)
    j_acc = np.asarray(jres.accepted)
    t_acc = tres.accepted.numpy()
    near = np.abs(np.exp(j_ratio) - u) <= NEAR_TIE
    np.testing.assert_array_equal(t_acc[~near], j_acc[~near])
    assert 0 < j_acc.sum() < C            # the decisions are mixed
    # the state follows the decisions; counters as the JAX update
    keep = t_acc == j_acc
    np.testing.assert_allclose(tres.state.positions.numpy()[keep],
                               np.asarray(jres.state.positions)[keep],
                               atol=1e-6)
    np.testing.assert_allclose(tres.state.energy.numpy()[keep],
                               np.asarray(jres.state.energy)[keep],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tres.state.attempts.numpy(),
                                  np.asarray(jres.state.attempts))
    np.testing.assert_array_equal(tres.state.accepts.numpy(), t_acc)


def test_infinite_proposal_energy_rejects():
    _, tspec, pos, props, _ = big_move_inputs(2)
    half_box = tspec.box.size_x / 2.0
    tm = build_circular_flow(N, 2, half_box, K=2, hidden_units=16,
                             num_bins=4, device="cpu")
    state = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0, 0.65)
    props[:, 2] = props[:, 1]                     # every proposal overlaps
    res = tmcmc.apply_big_moves(
        tspec, 1.0, state, torch.as_tensor(props),
        torch.full((C,), 1e6), tm, half_box, torch.zeros(C))
    assert torch.isinf(res.proposal_energy).all()
    assert not res.accepted.any()
    assert torch.equal(res.state.positions, state.positions)
    assert torch.equal(res.state.attempts, state.attempts + 1)


def test_nf_big_moves_paired_and_unpaired_agree():
    _, tspec, pos, _, _ = big_move_inputs(3)
    half_box = tspec.box.size_x / 2.0
    tm = build_circular_flow(N, 2, half_box, K=3, hidden_units=16,
                             num_bins=4, device="cpu").double()
    state = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0, 0.65)
    out = [tmcmc.nf_big_moves(tspec, 1.0, state, tm, half_box,
                              torch.Generator().manual_seed(4), paired=p)
           for p in (True, False)]
    np.testing.assert_allclose(out[0].ratio_log.numpy(),
                               out[1].ratio_log.numpy(), rtol=1e-10,
                               atol=1e-10)
    assert torch.equal(out[0].accepted, out[1].accepted)


def a1_config(out_dir, **kw):
    return dict(experiment_id="smoke_a1", output_dir=str(out_dir),
                num_chains=4, equilibration_steps=200, adjusting_frequency=100,
                sampling_frequency=10, initial_training_num_samples=64,
                batch_size=16, epochs=2, K=2, hidden_units=16, num_bins=4,
                big_move_attempts=3, big_move_interval=20,
                num_samples_for_analysis=100, **kw)


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def jax_a1(tmp_path_factory):
    from flowstate_tpu.experiments import algorithm1 as jalgorithm1
    from flowstate_tpu.utils.config import (
        algorithm1_config as j_algorithm1_config,
    )
    out = tmp_path_factory.mktemp("jax_a1")
    jalgorithm1.run(j_algorithm1_config(**a1_config(out)))
    return out


@pytest.mark.parametrize("matplotlib", [True, False])
def test_algorithm1_on_cpu_writes_the_jax_drivers_files(
        jax_a1, tmp_path, monkeypatch, matplotlib):
    if not matplotlib:
        monkeypatch.setattr(tplots, "_pyplot", lambda: None)
    res = algorithm1.run(algorithm1_config(**a1_config(tmp_path)),
                         device="cpu")
    assert np.isfinite(res["final_loss"])
    assert 0.0 <= res["big_move_acceptance"] <= 1.0
    assert set(res["phase_s"]) >= {"A", "B", "C", "D"}
    want = files_under(jax_a1)
    if not matplotlib:
        want = [f for f in want if not f.endswith((".png", ".svg"))]
    assert files_under(tmp_path) == want
    with open(jax_a1 / "evidence" / "smoke_a1_data.json") as f:
        j_keys = set(json.load(f))
    with open(tmp_path / "evidence" / "smoke_a1_data.json") as f:
        t_keys = set(json.load(f))
    assert t_keys - j_keys == {"phase_s"} and not j_keys - t_keys
    acc = np.loadtxt(tmp_path / "smoke_a1" / "acceptance_rate_data.csv",
                     delimiter=",", skiprows=1)
    assert acc.shape == (4, 2) and acc[-1, 1] == res["big_move_acceptance"]


def test_blocked_moves_are_not_ported_yet(tmp_path):
    """The blocked path of Algorithm 1 (N=4, k=1) on the CPU; the name is
    kept from when ``blocked_k > 0`` raised.  A finite loss, acceptance in
    [0, 1], ``df_particle`` and the sector counts, the conditional model
    saved in the JAX layout, no flow samples, and the depth in effect in
    the log (R3)."""
    res = algorithm1.run(algorithm1_config(**a1_config(
        tmp_path, num_particles=4, blocked_k=1, blocked_K=2)), device="cpu")
    assert np.isfinite(res["final_loss"])
    assert 0.0 <= res["big_move_acceptance"] <= 1.0
    assert np.isfinite(res["df_particle"])
    d = res["directory"]
    nf = os.path.join(d, "training_rounds", "initial_training_round")
    assert "samples.npy" not in os.listdir(nf)
    with open(os.path.join(nf, "initial_model_blocked_conditional.pkl"),
              "rb") as f:
        saved = pickle.load(f)
    assert set(saved[0]["net"]["blocks"][0]) == {"l1", "l2", "ctx"}
    with open(os.path.join(d, "experiment.log")) as f:
        assert "conditional flow K=blocked_K=2; K=2 unused" in f.read()
    with open(tmp_path / "evidence" / "smoke_a1_data.json") as f:
        evidence = json.load(f)
    assert sum(v for k, v in evidence["sector_counts"].items()
               if k != "burn_frac") > 0
    acc = np.loadtxt(os.path.join(d, "acceptance_rate_data.csv"),
                     delimiter=",", skiprows=1)
    assert acc.shape == (4, 2) and acc[-1, 1] == res["big_move_acceptance"]


def test_judge_flow_and_bulk_judge_follow_the_jax_rule():
    """Energy-only verdicts: ``(dE <= 0) | (u < exp(-beta dE))`` with the
    proposals' energies as JAX computes them and ``u`` from the
    generator."""
    jspec, tspec, pos, props, _ = big_move_inputs(4)
    state = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0, 0.65)
    j_e, _ = jax.vmap(lambda p: jops.total_energy_virial(jspec, p))(
        jnp.asarray(props))
    d_e = np.asarray(j_e) - state.energy.numpy()
    u = torch.rand(C, generator=torch.Generator().manual_seed(6)).numpy()
    want = (d_e <= 0.0) | (u < np.exp(-d_e))
    near = np.abs(np.exp(-d_e) - u) <= NEAR_TIE
    got = tmcmc.judge_flow(tspec, 1.0, state, torch.as_tensor(props),
                           torch.Generator().manual_seed(6)).numpy()
    np.testing.assert_array_equal(got[~near], want[~near])
    assert not got[5]                                   # the overlap
    ref = torch.full((C,), float(state.energy.mean()))
    d_b = np.asarray(j_e) - ref.numpy()
    want_b = (d_b <= 0.0) | (u < np.exp(-d_b))
    n, total = tmcmc.bulk_judge_flow(tspec, 1.0, torch.as_tensor(props), ref,
                                     torch.Generator().manual_seed(6))
    assert total == C
    assert abs(int(n) - int(want_b.sum())) <= int(
        (np.abs(np.exp(-d_b) - u) <= NEAR_TIE).sum())


def test_generate_samples_shapes_and_box():
    from flowstate_tpu_torch.flows import generate_samples

    half_box = 5.0
    tm = build_circular_flow(N, 2, half_box, K=2, hidden_units=16,
                             num_bins=4, device="cpu")
    out = generate_samples(tm, torch.Generator().manual_seed(0), 3, 7, N, 2)
    assert out.shape == (21, N, 2) and out.dtype == np.float32
    assert np.all(np.abs(out) <= half_box)
    flat = generate_samples(tm, torch.Generator().manual_seed(0), 3, 7)
    np.testing.assert_array_equal(flat.reshape(21, N, 2), out)
