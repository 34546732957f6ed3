"""The port's energy targets (``flowstate_tpu_torch.flows.targets``) and
``reverse_kld`` against the JAX package's on the same inputs.

Energies are held to JAX in float64 (inside ``jax.enable_x64``) to 1e-12
relative.  In float32 the port is held to JAX's float64 energy as closely
as JAX's own float32 run is: error <= 2 x JAX's float32 error + 1e-6
(torch and XLA round ``pow``, ``tanh`` and the sums differently in the
last bits; JAX's float32 error here is up to 8.7e-6 on energies up to
80).  The inputs hold points inside the
linearised hard core (r < 0.82), coordinates on the torus's edge (the
wrap, where round-half-to-even decides), and the reference's phantom
particle at the origin.  ``reverse_kld`` runs on the same base points in
both packages (a stand-in base returning a seeded numpy z) and is held
with its gradient to 1e-10 in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.flows import targets as jtargets
from flowstate_tpu_torch.flows import targets as ttargets
from flowstate_tpu_torch.flows import build_circular_flow, tree_map

from test_torch_flow import BOUND, DIM, N, flows, np_

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
F32_ATOL = 1e-6
WELLS = dict(V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def configurations(seed, m=40, n=N):
    """Centred configurations (m, n*2): uniform points; pairs at r = 0.05
    to 0.8 (the linear core) and at 0.82 +- 1e-3; coordinates on the
    edge (+-bound, the wrap) and beyond it; a pair straddling the edge."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-BOUND, BOUND, size=(m, n, DIM))
    for i, r in enumerate((0.05, 0.3, 0.6, 0.8, 0.819, 0.821)):
        ang = rng.uniform(0, 2 * np.pi)
        x[i, 1] = x[i, 0] + r * np.array([np.cos(ang), np.sin(ang)])
    x[6, 0] = (BOUND, -BOUND)
    x[7, :, 0] = -BOUND
    x[8, 0] = (BOUND + 0.3, 0.0)                 # beyond the edge: wraps
    x[9, 0], x[9, 1] = (BOUND - 0.1, 0.0), (-BOUND + 0.2, 0.0)
    x[10, 0] = (0.0, 0.0)                        # on the phantom
    return x.reshape(m, n * DIM)


def target_pairs(n=N):
    dim = n * DIM
    lj = dict(dim=dim, n_particles=n, temperature=1.3, bound=BOUND)
    return [
        ("SimpleLJ", dict(lj)),
        ("SimpleLJ", dict(lj, phantom_origin=True)),
        ("DoubleWellLJ", dict(lj, **WELLS)),
        ("DoubleWellLJ", dict(lj, phantom_origin=True, **WELLS)),
        ("DWNormal", dict(dim=dim, temperature=0.7, mu=1.5, sigma=0.6)),
        ("CoulombGas", dict(dim=dim, n_particles=n, temperature=2.0)),
    ]


def both(name, kw):
    return getattr(jtargets, name)(**kw), getattr(ttargets, name)(**kw)


@pytest.mark.parametrize("name,kw", target_pairs(),
                         ids=lambda v: v if isinstance(v, str) else
                         "phantom" if v.get("phantom_origin") else "")
def test_energy_matches_jax_in_float64(name, kw):
    x = configurations(1)
    jt, tt = both(name, kw)
    with jax.enable_x64(True):
        want = np.asarray(jt.energy(jnp.asarray(x)))
    got = np_(tt.energy(torch.as_tensor(x)))
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("name,kw", target_pairs(),
                         ids=lambda v: v if isinstance(v, str) else
                         "phantom" if v.get("phantom_origin") else "")
def test_energy_matches_jax_in_float32(name, kw):
    x = configurations(2).astype(np.float32)
    jt, tt = both(name, kw)
    j32 = np.asarray(jt.energy(jnp.asarray(x)))
    got = np_(tt.energy(torch.as_tensor(x)))
    with jax.enable_x64(True):
        want = np.asarray(jt.energy(jnp.asarray(x, jnp.float64)))
    port_err = np.abs(got - want).max()
    jax_err = np.abs(j32 - want).max()
    assert got.dtype == np.float32
    assert port_err <= 2 * jax_err + F32_ATOL, (port_err, jax_err)


def test_wrap_rounds_half_to_even_like_jax():
    """A coordinate at exactly +-bound sits at round(+-0.5) = 0 in both:
    the wrap leaves it where it is."""
    kw = dict(dim=N * DIM, n_particles=N, temperature=1.0, bound=BOUND)
    jt, tt = both("SimpleLJ", kw)
    x = configurations(3)[6:8]
    with jax.enable_x64(True):
        jd = np.asarray(jt._pair_distances(jnp.asarray(x)))
    np.testing.assert_allclose(np_(tt._pair_distances(torch.as_tensor(x))),
                               jd, **F64)


def test_double_well_gradient_matches_jax_grad():
    kw = dict(dim=N * DIM, n_particles=N, temperature=1.0, bound=BOUND,
              **WELLS)
    jt, tt = both("DoubleWellLJ", kw)
    x = configurations(4)
    with jax.enable_x64(True):
        jg = np.asarray(jax.grad(lambda a: jnp.sum(jt.energy(a)))(
            jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    tt.energy(xt).sum().backward()
    assert np.all(np.isfinite(jg))
    np.testing.assert_allclose(np_(xt.grad), jg, rtol=1e-10, atol=1e-10)


@dataclasses.dataclass(frozen=True)
class JaxFixedBase:
    """The JAX base with ``sample`` returning the given z."""

    base: object
    z: np.ndarray

    def sample(self, key, num_samples):
        return jnp.asarray(self.z[:num_samples])

    def log_prob(self, z):
        return self.base.log_prob(z)


@dataclasses.dataclass(frozen=True)
class TorchFixedBase:
    """The port's base with ``sample`` returning the given z."""

    base: object
    z: np.ndarray

    def sample(self, num_samples, generator=None, device="cpu"):
        return torch.as_tensor(np.array(self.z[:num_samples]), device=device)

    def log_prob(self, z):
        return self.base.log_prob(z)


def with_target_and_z(jm, tm, z):
    """The JAX flow and the port's with the DoubleWellLJ target and a
    base that draws ``z``."""
    kw = dict(dim=N * DIM, n_particles=N, temperature=1.0, bound=BOUND,
              **WELLS)
    jm = dataclasses.replace(jm, target=jtargets.DoubleWellLJ(**kw),
                             base=JaxFixedBase(jm.base, z))
    tm.target = ttargets.DoubleWellLJ(**kw)
    tm.base = TorchFixedBase(tm.base, z)
    return jm, tm


def test_reverse_kld_value_and_gradient_match_jax():
    z = np.random.default_rng(5).uniform(-BOUND, BOUND, size=(64, N * DIM))
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(3, 210)
        jm, tm = with_target_and_z(jm, tm, z)
        (jloss, jx), jgrads = jax.value_and_grad(
            lambda p: jm.reverse_kld(p, jax.random.key(0), 64),
            has_aux=True)(jp)
    loss, x = tm.reverse_kld(64)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(np_(x), np.asarray(jx), rtol=1e-10,
                               atol=1e-10)
    grads = tree_map(lambda p: p.grad.numpy(), tm.layers[0].params.tree())
    ours = jax.tree_util.tree_leaves(grads)
    theirs = jax.tree_util.tree_leaves(jgrads[0])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-10)


def small_flow():
    return build_circular_flow(N, DIM, BOUND, K=2, hidden_units=16,
                               num_bins=4, device="cpu",
                               generator=torch.Generator().manual_seed(0))


def test_reverse_kld_needs_a_target():
    tm = small_flow()
    with pytest.raises(ValueError, match="target"):
        tm.reverse_kld(4, torch.Generator().manual_seed(0))


def test_reverse_kld_draws_from_the_generator():
    """Without a stand-in the base points come from the generator: the
    same seed gives the same loss, another seed another one."""
    tm = small_flow()
    tm.target = ttargets.DoubleWellLJ(dim=N * DIM, n_particles=N,
                                      temperature=1.0, bound=BOUND, **WELLS)
    with torch.no_grad():
        a, xa = tm.reverse_kld(32, torch.Generator().manual_seed(1))
        b, _ = tm.reverse_kld(32, torch.Generator().manual_seed(1))
        c, _ = tm.reverse_kld(32, torch.Generator().manual_seed(2))
    assert a.item() == b.item() != c.item()
    assert xa.shape == (32, N * DIM) and bool(torch.isfinite(a))
