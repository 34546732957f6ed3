"""The port's physics (``flowstate_tpu_torch.ops``) against the JAX package.

Same numpy inputs through ``flowstate_tpu.ops`` (jnp, float32 on the CPU)
and ``flowstate_tpu_torch.ops`` (torch, float32 on the CPU).  Tolerance:
rtol 1e-5 / atol 1e-5 for energies and virials — the two packages round
``sqrt`` and ``** 6`` independently — and exact equality where the
arithmetic is the same (wrap, minimum image, initial configurations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _specs(n, box_args=(0.03, 1.0), num_wells=2):
    kw = dict(num_wells=num_wells, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    jbox = jops.Box.from_density(n, *box_args)
    tbox = tops.Box.from_density(n, *box_args)
    return (jops.SystemSpec.create(n, jbox, **kw),
            tops.SystemSpec.create(n, tbox, **kw))


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _configs(n, c, seed):
    """(C, N, 2) float32 configurations without hard-core overlaps: the
    in-well grids (N <= 12) or a lattice (N = 64), jittered and wrapped."""
    rng = np.random.default_rng(seed)
    if n <= 12:
        base, box = jmcmc.init_alternating_wells(c, n, 0.03)
    else:
        lattice, box = jmcmc.initialise_fcc(n, 0.3, 1.0)
        base = np.broadcast_to(lattice, (c, n, 2))
    pos = base + rng.uniform(-0.25, 0.25, size=(c, n, 2))
    pos = np.stack([pos[..., 0] % box.size_x, pos[..., 1] % box.size_y], -1)
    return pos.astype(np.float32)


def test_wrap_pbc_and_min_image_match_including_half_box():
    rng = np.random.default_rng(0)
    jbox, tbox = jops.Box(10.0, 7.0), tops.Box(10.0, 7.0)
    x = rng.uniform(-25.0, 25.0, size=(64, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        jops.wrap_pbc(jnp.asarray(x), jbox), tops.wrap_pbc(_t(x), tbox).numpy())
    np.testing.assert_array_equal(
        jops.min_image(jnp.asarray(x), jbox),
        tops.min_image(_t(x), tbox).numpy())
    # exactly half a box (and odd multiples): round half to even in both
    half = np.array([[5.0, 3.5], [-5.0, -3.5], [15.0, 10.5], [-15.0, -10.5]],
                    dtype=np.float32)
    out = tops.min_image(_t(half), tbox).numpy()
    np.testing.assert_array_equal(jops.min_image(jnp.asarray(half), jbox), out)
    np.testing.assert_array_equal(out[0], [5.0, 3.5])    # round(0.5) = 0
    np.testing.assert_array_equal(out[2], [-5.0, -3.5])  # round(1.5) = 2


def test_lennard_jones_double_well_and_tail_corrections():
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.uniform(0.3, 3.5, 500),
                        [1e-13, 0.5, 1.0, 2.5, 2.5000002]]).astype(np.float32)
    for shift in (True, False):
        je, jw = jops.lennard_jones_energy_virial(jnp.asarray(r), shift=shift)
        te, tw = tops.lennard_jones_energy_virial(_t(r), shift=shift)
        np.testing.assert_allclose(te.numpy(), je, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tw.numpy(), jw, rtol=RTOL, atol=ATOL)
    pos = rng.uniform(-2.0, 12.0, size=(40, 3, 2)).astype(np.float32)
    for nw, v0 in ((1, (-3.0,)), (2, (-10.0, -10.5))):
        jv = jops.double_well_potential(jnp.asarray(pos), 10.0, 10.0,
                                        V0_list=list(v0), r0=1.2, k=15.0,
                                        num_wells=nw)
        tv = tops.double_well_potential(_t(pos), 10.0, 10.0, V0_list=list(v0),
                                        r0=1.2, k=15.0, num_wells=nw)
        assert tv.shape == (40, 3)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tops.tail_correction_energy_2d(0.3, 64, 2.5),
        float(jops.tail_correction_energy_2d(0.3, 64, 2.5)), rtol=1e-6)
    np.testing.assert_allclose(
        tops.tail_correction_pressure_2d(0.3, 2.5),
        float(jops.tail_correction_pressure_2d(0.3, 2.5)), rtol=1e-6)


@pytest.mark.parametrize("n", [3, 12, 64])
def test_total_and_particle_energy_virial(n):
    jspec, tspec = _specs(n)
    pos = _configs(n, 6, seed=n)
    je, jw = jax.jit(jax.vmap(lambda p: jops.total_energy_virial(jspec, p)))(
        jnp.asarray(pos))
    te, tw = tops.total_energy_virial(tspec, _t(pos))
    assert np.all(np.isfinite(je))
    np.testing.assert_allclose(te.numpy(), je, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=RTOL, atol=ATOL)
    idx = np.random.default_rng(n).integers(0, n, size=6)
    jpe, jpw = jax.jit(jax.vmap(
        lambda p, i: jops.particle_energy_virial(jspec, p, i)))(
        jnp.asarray(pos), jnp.asarray(idx))
    tpe, tpw = tops.particle_energy_virial(tspec, _t(pos), torch.as_tensor(idx))
    np.testing.assert_allclose(tpe.numpy(), jpe, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tpw.numpy(), jpw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tops.pressure(tspec, tw, 1.0).numpy(), jops.pressure(jspec, jw, 1.0),
        rtol=RTOL, atol=ATOL)


def test_hard_core_overlap_is_inf_in_both():
    jspec, tspec = _specs(3)
    pos = np.array([[[2.0, 5.0], [2.3, 5.0], [8.0, 5.0]],
                    [[0.1, 5.0], [9.8, 5.0], [5.0, 5.0]]],  # across the edge
                   dtype=np.float32)
    je, jw = jax.jit(jax.vmap(lambda p: jops.total_energy_virial(jspec, p)))(
        jnp.asarray(pos))
    te, tw = tops.total_energy_virial(tspec, _t(pos))
    assert np.all(np.isposinf(je)) and np.all(np.isposinf(jw))
    assert torch.isposinf(te).all() and torch.isposinf(tw).all()
    idx = torch.tensor([0, 2])
    tpe, tpw = tops.particle_energy_virial(tspec, _t(pos), idx)
    assert torch.isposinf(tpe[0]) and torch.isposinf(tpw[0])
    assert torch.isfinite(tpe[1]) and torch.isfinite(tpw[1])


@pytest.mark.parametrize("n", [1, 3, 12])
def test_init_alternating_wells_equal(n):
    jpos, jbox = jmcmc.init_alternating_wells(7, n, 0.03)
    tpos, tbox = tmcmc.init_alternating_wells(7, n, 0.03)
    np.testing.assert_array_equal(tpos, jpos)
    assert tuple(tbox) == tuple(jbox)
