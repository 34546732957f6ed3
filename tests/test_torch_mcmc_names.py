"""The JAX package's ``mcmc`` names that the port gained last, against JAX.

* ``initialise_fcc_left_half`` and ``initialise_fcc_right_half``:
  bit-equal positions and the same box.
* ``metropolis_move`` and ``hmc_move``: one step of the port's batched
  engines fed the draws JAX's one-chain functions take from their keys
  (rebuilt here with ``jax.random`` on JAX's own keys), against those
  functions vmapped over the chains.
* ``run_production`` and the ``*_batch`` names: the port's engines are
  batched already, so the ``*_batch`` names are the same functions; each
  is called with JAX's arguments and, where it takes draws, fed JAX's and
  held against JAX's run.

Decisions must agree; positions within 1e-5 and energies within 1e-4, the
engine tests' tolerances (``test_torch_metropolis.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS

from test_torch_mala_hmc import assert_states_close, pair_states, specs

torch.set_num_threads(1)

POS_ATOL = 1e-5
E_ATOL = 1e-4


@pytest.mark.parametrize("n,rho,aspect", [(12, 0.03, 1.0), (48, 0.5, 1.5),
                                          (33, 0.3, 1.0)])
def test_half_box_lattices_equal_jax(n, rho, aspect):
    for name in ("initialise_fcc_left_half", "initialise_fcc_right_half"):
        jpos, jbox = getattr(jmcmc, name)(n, rho, aspect)
        tpos, tbox = getattr(tmcmc, name)(n, rho, aspect)
        np.testing.assert_array_equal(tpos, jpos)
        assert (tbox.size_x, tbox.size_y) == (jbox.size_x, jbox.size_y)


@functools.lru_cache(maxsize=None)
def _draw_fn(n, moves):
    def one(key):
        key, k_p, k_d, k_a = jax.random.split(key, 4)
        return (key, jax.random.randint(k_p, (moves,), 0, n),
                jax.random.uniform(k_d, (moves, 2), dtype=jnp.float32),
                jax.random.uniform(k_a, (moves,), dtype=jnp.float32))

    return jax.jit(jax.vmap(one))


def metropolis_draws(js, n, moves):
    """The tables JAX's ``run_moves`` draws from each chain's key for
    ``moves`` <= 256 moves (one chunk), and the chains' next keys."""
    key, p, d, u = _draw_fn(n, moves)(js.key)
    return key, tuple(torch.tensor(np.asarray(a))
                      for a in (p.astype(jnp.int32), d, u))


def port_state(js, seed=0):
    return tmcmc.chain_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}, seed, "cpu")


def assert_same(jspec, ts, js, virial=True):
    np.testing.assert_array_equal(ts.accepts.numpy(), np.asarray(js.accepts))
    np.testing.assert_array_equal(ts.attempts.numpy(),
                                  np.asarray(js.attempts))
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions),
                               atol=POS_ATOL)
    je, jw = jax.vmap(lambda p: jops.total_energy_virial(jspec, p))(
        jnp.asarray(ts.positions.numpy()))
    np.testing.assert_allclose(ts.energy.numpy(), np.asarray(je),
                               rtol=1e-5, atol=E_ATOL)
    if virial:
        np.testing.assert_allclose(ts.virial.numpy(), np.asarray(jw),
                                   rtol=1e-5, atol=E_ATOL)


def test_metropolis_move_is_jax_one_step_on_its_draws():
    jspec, tspec = specs(3)
    js, _ = pair_states(jspec, tspec, 64, 0.65, 5)
    ts = port_state(js)
    step = jax.jit(jax.vmap(lambda s: jmcmc.metropolis_move(jspec, 1.0, s)))
    for _ in range(10):
        # metropolis_move splits the key once, as a chunk of one move does
        _, (p, d, u) = metropolis_draws(js, 3, 1)
        ts = tmcmc.metropolis_move(tspec, 1.0, ts, (p, d, u))
        js = step(js)
        assert_same(jspec, ts, js)
    assert ts.calls == 10
    assert 0 < int(ts.accepts.sum()) < 64 * 10


def test_hmc_move_is_jax_one_trajectory_on_its_draws():
    jspec, tspec = specs(3)
    js, _ = pair_states(jspec, tspec, 48, 0.08, 3)
    leapfrog = 4

    def draws(key):
        key, k_mom, k_acc = jax.random.split(key, 3)
        return (jax.random.normal(k_mom, (3, 2), dtype=jnp.float32),
                jax.random.uniform(k_acc, (), dtype=jnp.float32))

    step = jax.jit(jax.vmap(lambda s: jmcmc.hmc_move(jspec, 1.0, s,
                                                     leapfrog)))
    # each trajectory from JAX's state: LJ repulsion near contact turns
    # float32 rounding into 1e-5 of position a trajectory, which would
    # otherwise add up over the steps
    for i in range(5):
        p0, u = jax.vmap(draws)(js.key)
        ts = tmcmc.hmc_move(tspec, 1.0, port_state(js, 0).replace(calls=i),
                            leapfrog, torch.as_tensor(np.asarray(p0)),
                            torch.as_tensor(np.asarray(u)))
        js = step(js)
        assert_states_close(jspec, ts, js)
    assert ts.calls == 5
    assert 0 < int(ts.accepts.sum()) < 48 * 5
    with pytest.raises(ValueError):
        tmcmc.hmc_move(tspec, 1.0, ts, leapfrog, p0=torch.zeros(48, 3, 2))


def test_run_production_and_its_batch_form_match_jax():
    jspec, tspec = specs(3)
    c, samples, freq = 24, 6, 40
    js, _ = pair_states(jspec, tspec, c, 0.65, 8)
    ts = port_state(js)
    # JAX's run_production splits each chain's key once a block (one
    # chunk of ``freq`` moves); rebuild those tables block after block
    tables, key = [], js.key
    for _ in range(samples):
        key, tab = metropolis_draws(js._replace(key=key), 3, freq)
        tables.append(tab)
    tables = tuple(torch.cat([t[i] for t in tables], dim=1) for i in range(3))
    j_end, j_obs = jmcmc.run_production_batch(jspec, 1.0, js, samples, freq,
                                              start_cycle=100)
    assert tmcmc.run_production_batch is tmcmc.run_production
    t_end, t_obs = tmcmc.run_production_batch(tspec, 1.0, ts, samples, freq,
                                              start_cycle=100, tables=tables)
    assert_same(jspec, t_end, j_end)
    np.testing.assert_array_equal(t_obs.cycle.numpy(), np.asarray(j_obs.cycle))
    for f in ("energy_per_particle", "pressure"):
        np.testing.assert_allclose(getattr(t_obs, f).numpy(),
                                   np.asarray(getattr(j_obs, f)),
                                   rtol=1e-4, atol=1e-4)
    for f in ("density", "box_size_x", "box_size_y"):
        np.testing.assert_allclose(getattr(t_obs, f).numpy(),
                                   np.asarray(getattr(j_obs, f)), rtol=1e-6)
    np.testing.assert_allclose(t_obs.positions.numpy(),
                               np.asarray(j_obs.positions), atol=POS_ATOL)
    # drawn, it runs as run_production_with over run_moves does
    a, obs_a = tmcmc.run_production(tspec, 1.0, ts, 3, 10)
    b, obs_b = tmcmc.run_production_with(
        tspec, 1.0, ts, 3, 10,
        lambda s, m: tmcmc.run_moves(tspec, 1.0, s, m))
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(obs_a.energy_per_particle, obs_b.energy_per_particle)


def test_moves_equilibration_and_production_with_batch_names_take_jax_args():
    jspec, tspec = specs(3)
    c, moves = 16, 30
    js, _ = pair_states(jspec, tspec, c, 0.65, 9)
    ts = port_state(js)
    assert tmcmc.run_moves_batch is tmcmc.run_moves
    assert tmcmc.run_equilibration_batch is tmcmc.run_equilibration
    assert tmcmc.run_production_with_batch is tmcmc.run_production_with
    assert tmcmc.run_hmc_batch is tmcmc.run_hmc
    assert tmcmc.run_hmc_equilibration_batch is tmcmc.run_hmc_equilibration

    _, tab = metropolis_draws(js, 3, moves)
    j1 = jmcmc.run_moves_batch(jspec, 1.0, js, moves)
    t1 = tmcmc.run_moves_batch(tspec, 1.0, ts, moves, tab)
    assert_same(jspec, t1, j1)

    # equilibration: JAX's blocks of adjusting_frequency moves, each one
    # chunk split from the key, fed through the port's move_fn
    steps, adjust = 90, 30
    key, feed = js.key, []
    for _ in range(steps // adjust):
        key, t = metropolis_draws(js._replace(key=key), 3, adjust)
        feed.append(t)
    feed = iter(feed)
    j2 = jmcmc.run_equilibration_batch(jspec, 1.0, js, steps, adjust, 0.5)
    t2 = tmcmc.run_equilibration_batch(
        tspec, 1.0, ts, steps, adjust, 0.5,
        move_fn=lambda s, m: tmcmc.run_moves(tspec, 1.0, s, m, next(feed)))
    assert_same(jspec, t2, j2)
    np.testing.assert_allclose(t2.max_disp.numpy(), np.asarray(j2.max_disp),
                               rtol=1e-6)

    # production with a move function: the plain engine on JAX's draws
    samples, freq = 3, 20
    key, feed = js.key, []
    for _ in range(samples):
        key, t = metropolis_draws(js._replace(key=key), 3, freq)
        feed.append(t)
    feed = iter(feed)
    j3, jo = jmcmc.run_production_with_batch(
        jspec, 1.0, js, samples, freq,
        lambda s, m: jmcmc.run_moves(jspec, 1.0, s, m))
    t3, to = tmcmc.run_production_with_batch(
        tspec, 1.0, ts, samples, freq,
        lambda s, m: tmcmc.run_moves(tspec, 1.0, s, m, next(feed)))
    assert_same(jspec, t3, j3)
    np.testing.assert_allclose(to.energy_per_particle.numpy(),
                               np.asarray(jo.energy_per_particle), atol=1e-4)

    # HMC's batch names with JAX's arguments (spec, beta, state, moves,
    # leapfrog): the port's own trajectories, advancing its stream
    hs, _ = pair_states(jspec, tspec, 8, 0.08, 4)
    h0 = port_state(hs)
    h1 = tmcmc.run_hmc_batch(tspec, 1.0, h0, 3, 4)
    h2 = tmcmc.run_hmc_equilibration_batch(tspec, 1.0, h0, 6, 3, 4, 0.65)
    assert h1.calls == 1 and h2.calls == 2
    assert bool((h1.attempts == 3).all()) and bool((h2.attempts == 6).all())
