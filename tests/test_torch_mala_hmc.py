"""The port's MALA and HMC (``mcmc/mala.py``, ``mcmc/hmc.py``) against the
JAX package.

* ``potential_gradient`` against ``jax.grad`` of the JAX energy on the
  same configurations, float32: |d| <= 1e-4 (|g| + 1).
* An overlapping configuration gets an all-zero gradient, and the other
  chains of its batch keep theirs bit for bit.
* ``mala_apply`` and ``hmc_apply`` on drawn noise, momenta and uniforms,
  several steps in a row, against the JAX single-chain updates vmapped:
  the accept flags equal, positions atol 1e-5, and the tracked energy and
  virial within 1e-5 relative (atol 1e-4) of JAX's energy of the port's
  positions.
* ``adjust_tau`` / ``adjust_eps`` equal to JAX's on the same counters.
* The N=1 double well's ΔF within 0.12 of the quadrature, for MALA and
  HMC on the CPU (the bound of the JAX package's MALA test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.mcmc.hmc import _hmc_apply
from flowstate_tpu.mcmc.mala import _mala_apply
from flowstate_tpu.ops.potentials import double_well_potential
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops

torch.set_num_threads(1)

WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def specs(n, rho=0.03, **kw):
    kw = kw or WELLS
    return (jops.SystemSpec.create(n, jops.Box.from_density(n, rho), **kw),
            tops.SystemSpec.create(n, tops.Box.from_density(n, rho), **kw))


def spread_configs(spec, c, seed, min_r=0.8):
    """(C, N, 2) float32 configurations with no pair closer than min_r."""
    rng = np.random.default_rng(seed)
    lx, ly = spec.box.size_x, spec.box.size_y
    out = []
    while len(out) < c:
        p = rng.uniform(0, 1, (spec.num_particles, 2)) * [lx, ly]
        d = p[:, None] - p[None]
        d -= np.round(d / [lx, ly]) * [lx, ly]
        r = np.hypot(d[..., 0], d[..., 1]) + 10 * np.eye(len(p))
        if r.min() > min_r:
            out.append(p)
    return np.asarray(out, dtype=np.float32)


@pytest.mark.parametrize("n,rho,wells", [(3, 0.03, True), (8, 0.3, False)])
def test_potential_gradient_matches_jax_grad(n, rho, wells):
    jspec, tspec = specs(n, rho, **(WELLS if wells else {"num_wells": 0}))
    pos = spread_configs(tspec, 32, n)
    g = tmcmc.potential_gradient(tspec, torch.as_tensor(pos)).numpy()
    jg = np.asarray(jax.vmap(lambda p: jmcmc.potential_gradient(jspec, p))(
        jnp.asarray(pos)))
    assert g.dtype == np.float32 and np.abs(jg).max() > 1.0
    assert np.all(np.abs(g - jg) <= 1e-4 * (np.abs(jg) + 1.0))


def test_overlap_gives_a_zero_gradient_and_spares_the_others():
    jspec, tspec = specs(3)
    pos = spread_configs(tspec, 6, 1)
    pos[2] = [[5.0, 5.0], [5.1, 5.0], [8.0, 2.0]]          # r = 0.1
    pos[4] = [[5.0, 5.0], [5.0, 5.0], [1.0, 2.0]]          # r = 0
    g = tmcmc.potential_gradient(tspec, torch.as_tensor(pos))
    assert bool(torch.isfinite(g).all())
    assert not bool(g[[2, 4]].any())
    keep = [0, 1, 3, 5]
    alone = tmcmc.potential_gradient(tspec, torch.as_tensor(pos[keep]))
    assert torch.equal(g[keep], alone)
    # the JAX gradient of an overlap is finite too (its own test) and zero
    jg = np.asarray(jmcmc.potential_gradient(jspec, jnp.asarray(pos[2])))
    np.testing.assert_array_equal(jg, 0.0)


def pair_states(jspec, tspec, c, step, seed):
    pos, _ = jmcmc.init_alternating_wells(c, tspec.num_particles, 0.03)
    rng = np.random.default_rng(seed)
    pos = (pos + rng.normal(0, 0.15, pos.shape)).astype(np.float32)
    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos), jax.random.key(0),
                                step)
    ts = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0, step)
    return js, ts


def assert_states_close(jspec, ts, js):
    """Decisions equal, positions within 1e-5; the energy and virial are
    held to JAX's energy of the port's own positions, since LJ repulsion
    near contact turns the 1e-6 the two parts by into 1e-4 of energy."""
    np.testing.assert_array_equal(ts.accepts.numpy(), np.asarray(js.accepts))
    np.testing.assert_array_equal(ts.attempts.numpy(),
                                  np.asarray(js.attempts))
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions),
                               atol=1e-5)
    je, jw = jax.vmap(lambda p: jops.total_energy_virial(jspec, p))(
        jnp.asarray(ts.positions.numpy()))
    for mine, ref in ((ts.energy, je), (ts.virial, jw)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sampler", ["mala", "hmc"])
def test_apply_matches_jax(sampler):
    jspec, tspec = specs(3)
    c, steps, leapfrog = 48, 6, 4
    step = 0.02 if sampler == "mala" else 0.08
    js, ts = pair_states(jspec, tspec, c, step, 3)
    rng = np.random.default_rng(11)
    if sampler == "mala":
        jfn = jax.jit(jax.vmap(lambda s, z, u: _mala_apply(jspec, 1.0, s, z,
                                                           u)))
        tfn = lambda s, z, u: tmcmc.mala_apply(tspec, 1.0, s, z, u)  # noqa
    else:
        jfn = jax.jit(jax.vmap(lambda s, z, u: _hmc_apply(
            jspec, 1.0, s, z, u, leapfrog)))
        tfn = lambda s, z, u: tmcmc.hmc_apply(tspec, 1.0, s, z, u,  # noqa
                                              leapfrog)
    for _ in range(steps):
        z = rng.standard_normal((c, 3, 2)).astype(np.float32)
        u = rng.random(c, dtype=np.float32)
        js = jfn(js, jnp.asarray(z), jnp.asarray(u))
        ts = tfn(ts, torch.as_tensor(z), torch.as_tensor(u))
        assert_states_close(jspec, ts, js)
    acc = ts.accepts.numpy()
    assert 0 < acc.sum() < c * steps


def test_adaptation_equals_jax():
    jspec, tspec = specs(3)
    js, ts = pair_states(jspec, tspec, 6, 0.3, 4)
    attempts = np.array([0, 10, 10, 10, 100, 7], dtype=np.int32)
    accepts = np.array([0, 0, 5, 10, 61, 3], dtype=np.int32)
    js = js._replace(attempts=jnp.asarray(attempts),
                     accepts=jnp.asarray(accepts))
    ts = ts.replace(attempts=torch.as_tensor(attempts),
                    accepts=torch.as_tensor(accepts))
    for tfn, jfn in ((tmcmc.adjust_tau, jmcmc.adjust_tau),
                     (tmcmc.adjust_eps, jmcmc.adjust_eps)):
        mine, ref = tfn(ts), jfn(js)
        np.testing.assert_array_equal(mine.max_disp.numpy(),
                                      np.asarray(ref.max_disp))
        np.testing.assert_array_equal(mine.prev_attempts.numpy(),
                                      np.asarray(ref.prev_attempts))


def quadrature_delta_f(spec):
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    v = np.asarray(double_well_potential(
        jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1)), lx, ly,
        V0_list=list(spec.V0_list), r0=spec.r0, k=spec.k)).reshape(g, g)
    w = np.exp(-v)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    in_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    return float(np.log(w[in_b].sum() / w[in_a].sum()))


@pytest.mark.parametrize("sampler", ["mala", "hmc"])
def test_single_particle_free_energy_matches_quadrature(sampler):
    _, spec = specs(1, 0.01, num_wells=2, V0_list=(-2.0, -2.5), r0=1.2,
                    k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    exact = quadrature_delta_f(spec)
    c = 256
    pos0 = np.tile(np.array([[lx / 4, ly / 2]], dtype=np.float32), (c, 1, 1))
    pos0[c // 2:, :, 0] = 3 * lx / 4
    state = tmcmc.init_chain_state(spec, torch.as_tensor(pos0), 7, 0.3)
    frames = []
    if sampler == "mala":
        state = tmcmc.run_mala_equilibration(spec, 1.0, state, 300, 50)
        for _ in range(120):
            state = tmcmc.run_mala(spec, 1.0, state, 5)
            frames.append(state.positions.numpy())
    else:
        state = tmcmc.run_hmc_equilibration(spec, 1.0, state, 200, 25,
                                            num_leapfrog=5)
        for _ in range(120):
            state = tmcmc.run_hmc(spec, 1.0, state, 3, num_leapfrog=5)
            frames.append(state.positions.numpy())
    xy = np.concatenate(frames).reshape(-1, 2)
    in_a = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= 1.1 * spec.r0
    in_b = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= 1.1 * spec.r0
    sampled = np.log(in_b.sum() / in_a.sum())
    assert abs(sampled - exact) < 0.12, (sampled, exact)
