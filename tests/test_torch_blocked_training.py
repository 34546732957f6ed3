"""The port's conditional training (``flowstate_tpu_torch.training.
blocked``) against the JAX package's, and the blocked chain's
equilibrium (ROADMAP R4).

One Adam step from the same weights and batch is held to JAX's in
float64; ``train_blocked``'s epochs and errors; and a blocked MH chain
with a perturbed flow keeps the Metropolis engine's well occupancy.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.training import TrainConfig as JTrainConfig
from flowstate_tpu.training.blocked import (
    make_blocked_train_step as j_make_step,
)
from flowstate_tpu.training.train import TrainState, make_optimizer
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.flows import (
    build_conditional_circular_flow, params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_plain
from flowstate_tpu_torch.mcmc.metropolis import run_production_with
from flowstate_tpu_torch.mcmc.state import batched_energy_virial
from flowstate_tpu_torch.training import (
    Adam, TrainConfig, blocked_pairs, make_blocked_train_step, train_blocked,
)

from test_torch_blocked import (
    BINS, CTX, F64, HB, HIDDEN, M_MAX, cond_flows, np_, positions,
)
from test_torch_flow import random_tree, to_jax

torch.set_num_threads(1)


# ----- conditional training --------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_blocked_train_step_matches_jax(k):
    """One conditional-MLE Adam step from the same weights and batch, in
    float64: the same loss, and parameter updates within 1e-8 (lr 1e-2,
    weight decay on); a NaN batch leaves the parameters and advances
    Adam's count."""
    jm, tree, tm = cond_flows(k, 90 + k, K=2)
    rng = np.random.default_rng(91)
    x = rng.uniform(-HB, HB, (24, 2 * k))
    c = rng.normal(size=(24, CTX))
    cfg = dict(batch_size=24, lr=1e-2, weight_decay=1e-3)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        opt = make_optimizer(JTrainConfig(**cfg))
        state = TrainState(jp, opt.init(jp), jax.random.key(0))
        state, j_loss = j_make_step(jm, JTrainConfig(**cfg), opt)(
            state, (jnp.asarray(x), jnp.asarray(c)))
        j_new = jax.tree_util.tree_map(np.asarray, state.params)
    adam = Adam(cfg["lr"], cfg["weight_decay"])
    step = make_blocked_train_step(tm, adam)
    opt_state = adam.init(list(tm.parameters()))
    opt_state, t_loss = step(opt_state, (torch.as_tensor(x),
                                         torch.as_tensor(c)))
    np.testing.assert_allclose(float(t_loss), float(j_loss), **F64)
    for old, new, got in zip(jax.tree_util.tree_leaves(tuple(tree)),
                             jax.tree_util.tree_leaves(j_new),
                             jax.tree_util.tree_leaves(params_to_jax(tm))):
        np.testing.assert_allclose(got - old, new - old, rtol=0, atol=1e-8)
    before = [p.detach().clone() for p in tm.parameters()]
    bad = x.copy()
    bad[3, 0] = np.nan
    opt_state, loss = step(opt_state, (torch.as_tensor(bad),
                                       torch.as_tensor(c)))
    assert not torch.isfinite(loss)
    assert opt_state.count == 2
    for p, q in zip(before, tm.parameters()):
        assert torch.equal(p, q)


def test_train_blocked_epochs_and_errors():
    n, k, s = 6, 1, 70
    configs = torch.as_tensor(positions(11, s, n), dtype=torch.float32)
    x, ctx = blocked_pairs(torch.Generator().manual_seed(1), configs, k, HB)
    assert x.shape == (s, 2 * k) and ctx.shape == (s, 4 * (n - k))
    assert float(x.abs().max()) <= HB
    tm = build_conditional_circular_flow(
        k, 2, HB, context_features=CTX, K=2, hidden_units=HIDDEN,
        num_bins=BINS, device="cpu", generator=torch.Generator().manual_seed(2))
    context_fn = lambda r, p: tmcmc.fourier_context(r, p, HB, M_MAX)  # noqa
    cfg = TrainConfig(batch_size=16, epochs=3, lr=3e-3)
    _, opt_state, loss_epoch = train_blocked(
        tm, configs, k, HB, cfg, torch.Generator().manual_seed(3),
        context_fn=context_fn)
    assert opt_state.count == 3 * (s // 16)
    assert len(loss_epoch) == 3 and np.all(np.isfinite(loss_epoch))
    with pytest.raises(ValueError, match="configs < batch_size"):
        train_blocked(tm, configs[:15], k, HB, cfg,
                      torch.Generator().manual_seed(3))


# ----- R4: the blocked chain keeps the Metropolis occupancy -------------

def test_blocked_mh_keeps_the_metropolis_well_occupancy():
    """N=4, shallow wells (-2 / -2.5 kT, so that local moves cross within
    the test) and a perturbed conditional flow: the blocked MH chain's
    per-particle ΔF = ln(n_B / n_A) equals the Metropolis engine's within
    0.2, the JAX test's bound (tests/test_blocked.py:148-207)."""
    n, k, c = 4, 1, 256
    spec = tops.SystemSpec.create(n, tops.Box.from_density(n, 0.03, 1.0),
                                  num_wells=2, V0_list=(-2.0, -2.5), r0=1.2,
                                  k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    hb = lx / 2
    pos, _ = tmcmc.init_alternating_wells(c, n, 0.03)
    state = tmcmc.init_chain_state(spec, torch.as_tensor(pos), 13, 1.5)
    state = run_moves_plain(spec, 1.0, state, 400)

    tm = build_conditional_circular_flow(
        k, 2, hb, context_features=CTX, K=2, hidden_units=16, num_bins=4,
        device="cpu")
    params_from_jax(random_tree(params_to_jax(tm), 14, 0.3), tm)
    g = torch.Generator().manual_seed(15)
    context_fn = lambda r, p: tmcmc.fourier_context(r, p, hb, M_MAX)  # noqa
    s, traj = state, []
    for i in range(900):
        s = tmcmc.blocked_big_moves(spec, 1.0, s, tm, hb, k, g,
                                    context_fn).state
        if i >= 300:
            traj.append(s.positions)
    acc = float((s.accepts - state.accepts).sum()
                / (s.attempts - state.attempts).sum())
    assert 0.01 < acc < 0.9, acc
    # the energies the moves carried are the positions' own
    energy, _ = batched_energy_virial(spec, s.positions)
    np.testing.assert_allclose(np_(s.energy), np_(energy), rtol=1e-5,
                               atol=1e-4)

    def delta_f(xy):
        xy = xy.reshape(-1, 2)
        radius = 1.1 * spec.r0
        in_a = np.hypot(xy[:, 0] - lx / 4, xy[:, 1] - ly / 2) <= radius
        in_b = np.hypot(xy[:, 0] - 3 * lx / 4, xy[:, 1] - ly / 2) <= radius
        return np.log(in_b.sum() / in_a.sum())

    df_blocked = delta_f(torch.stack(traj).numpy())
    state_m = tmcmc.init_chain_state(spec, torch.as_tensor(pos), 16, 1.5)
    state_m = run_moves_plain(spec, 1.0, state_m, 1000)
    _, obs = run_production_with(
        spec, 1.0, state_m, 400, 8,
        lambda st, m: tmcmc.resync_energy(spec, run_moves_plain(
            spec, 1.0, st, m)))
    df_metro = delta_f(obs.positions.numpy())
    assert abs(df_blocked - df_metro) < 0.2, (df_blocked, df_metro)


@pytest.mark.parametrize("driver", ["a1", "a2"])
def test_blocked_recipe_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch,
                                                   driver):
    """The recipe tool on the JAX evidence file's configuration cut to a
    CPU's size: its JSON line holds the port's numbers beside JAX's."""
    from flowstate_tpu_torch.tools import blocked_recipe

    full = blocked_recipe.jax_config

    def small(name):
        doc, cfg = full(name)
        return doc, {**cfg, "num_chains": 4, "equilibration_steps": 200,
                     "adjusting_frequency": 100, "sampling_frequency": 10,
                     "initial_training_num_samples": 32,
                     "update_num_samples": 32, "batch_size": 16,
                     "epochs": 1, "hidden_units": 16, "num_bins": 4,
                     "big_move_attempts": 3, "num_training_cycles": 2,
                     "num_samples_for_analysis": 64,
                     "num_samples_for_free_energy": 8}

    monkeypatch.setattr(blocked_recipe, "jax_config", small)
    evidence = tmp_path / f"blocked_recipe_torch_{driver}_data.json"
    line = blocked_recipe.main(["--driver", driver, "--output_dir",
                                str(tmp_path), "--evidence", str(evidence),
                                "--device", "cpu"])
    assert line["card"] == "cpu" and line["blocked_K"] == 10
    assert line["num_particles"] == 8 and line["chains"] == 4
    assert line["jax"]["peak"] == "4B"
    assert 0.0 <= line["port"]["acceptance"] <= 1.0
    assert np.isfinite(line["port"]["df_particle"])
    assert np.isfinite(line["port"]["final_loss"])
    assert line["master_seed"] == 42
    assert set(line["in_range"]) == {"acceptance", "peak", "df_particle"}
    with open(evidence) as f:
        assert json.load(f)["driver"] == driver
