"""The port's toy targets, stochastic layers, HAIS, VAE and flow models
(``flowstate_tpu_torch.flows``), and the slice as a whole, against the
JAX package's.

The stochastic layers, HAIS and the VAE take their noise as tensors
(``run``, ``sample_from``, ``from_noise``); the tests rebuild JAX's draws
from its keys, following JAX's key splits, and give both packages the
same numbers.  The distribution checks of ``tests/test_flow_zoo.py``
(:218-276) run on the port alone.  The slice: a K=2
``CircularAutoregressiveRationalQuadraticSpline`` flow over
``UniformParticle`` at N=3, with one big-move round on JAX's proposals.
Tolerances:

* float64, the same arithmetic: 1e-10 (``F64``), JAX's MADE without its
  float32 products (``test_torch_flow_zoo.py``, ROADMAP R14);
* the big-move round in float32, as the drivers run it: proposals and
  log q within the flows' float32 rounding (``PROP_ATOL``, ``LQ_TOL``),
  energies on the port's own proposals (LJ repulsion amplifies 1e-6 of
  position), the MH log-ratio's other terms to 1e-5 of their magnitude,
  and an accept flipping only where ``u`` lies between the two packages'
  acceptance probabilities, widened by ``NEAR_TIE`` (ROADMAP R2);
* the sampling checks at their ``tests/test_flow_zoo.py`` bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowstate_tpu.flows as jflows
from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.flows import autoregressive as jautoregressive
from flowstate_tpu.flows import toy_targets as jtoy
import flowstate_tpu_torch.flows as tflows
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.flows import (
    ClassCondFlow, ConditionalNormalizingFlow, NormalizingFlow, ParamLayer,
    params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.flows import toy_targets as ttoy

from test_torch_flow import F64, np_, random_tree, to_jax, to_torch

torch.set_num_threads(1)

F64_T = torch.float64
NEAR_TIE = 1e-4
PROP_ATOL = 2e-5       # float32 flows of two packages, positions
LQ_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def jax_made_in_float64(monkeypatch):
    """JAX's MADE without its float32 products (R14)."""
    dot = jnp.dot

    def float64_dot(*args, preferred_element_type=None, **kwargs):
        return dot(*args, **kwargs)

    monkeypatch.setattr(jautoregressive.jnp, "dot", float64_dot)


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np_(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **(tol or F64))


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


# ----- toy targets -----------------------------------------------------

TARGETS = {
    "two_moons": lambda m: m.TwoMoons(),
    "circular_gaussian_mixture": lambda m: m.CircularGaussianMixture(),
    "ring_mixture": lambda m: m.RingMixture(3),
    "two_modes": lambda m: m.TwoModes(2.0, 0.2),
    "sinusoidal": lambda m: m.Sinusoidal(0.4, 3.0),
    "sinusoidal_gap": lambda m: m.SinusoidalGap(0.4, 3.0),
    "sinusoidal_split": lambda m: m.SinusoidalSplit(0.4, 3.0),
    "smiley": lambda m: m.Smiley(0.5),
    "linear_interpolation": lambda m: m.LinearInterpolation(
        m.TwoMoons(), m.Smiley(0.5), 0.3),
}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_toy_target_log_prob_matches_jax(name):
    z = 1.5 * normal(1, (64, 2))
    with jax.enable_x64(True):
        j = TARGETS[name](jflows).log_prob(jnp.asarray(z))
    t = TARGETS[name](tflows).log_prob(torch.as_tensor(z))
    assert t.shape == (64,) and t.dtype == F64_T
    assert_close(t, j)


def test_conditional_and_product_targets_match_jax():
    z4 = normal(2, (32, 4))
    ctx = np.concatenate([normal(3, (32, 4)),
                          np.exp(0.3 * normal(4, (32, 4)))], axis=1)
    with jax.enable_x64(True):
        j_cond = jflows.ConditionalDiagGaussian().log_prob(
            jnp.asarray(z4), jnp.asarray(ctx))
        j_two = jflows.TwoIndependent(jflows.TwoMoons(), jflows.RingMixture(),
                                      2).log_prob(jnp.asarray(z4))
    assert_close(tflows.ConditionalDiagGaussian().log_prob(
        torch.as_tensor(z4), torch.as_tensor(ctx)), j_cond)
    two = tflows.TwoIndependent(tflows.TwoMoons(), tflows.RingMixture(), 2)
    assert_close(two.log_prob(torch.as_tensor(z4)), j_two)
    g = torch.Generator().manual_seed(5)
    assert two.sample(50, g, "cpu").shape == (50, 4)
    s = tflows.ConditionalDiagGaussian().sample(
        32, torch.as_tensor(ctx), g)
    assert s.shape == (32, 4) and s.dtype == F64_T


def image():
    img = np.zeros((8, 8))
    img[0:4, 4:8] = 1.0          # bright top-right quadrant
    return img


def test_image_prior_matches_jax_and_samples_the_bright_quadrant():
    z = np.random.default_rng(6).uniform(-1.2, 1.2, size=(64, 2))
    with jax.enable_x64(True):
        j = jflows.ImagePrior(image(), (-1.0, 1.0), (-1.0, 1.0)).log_prob(
            jnp.asarray(z))
    prior = tflows.ImagePrior(image(), (-1.0, 1.0), (-1.0, 1.0),
                              device="cpu")
    np.testing.assert_array_equal(np_(prior.log_prob(torch.as_tensor(z))),
                                  np.asarray(j))
    s = prior.sample(200, torch.Generator().manual_seed(7))
    assert s.shape == (200, 2) and torch.all(s.abs() <= 1.0)
    assert float((s > 0.0).all(1).double().mean()) > 0.95


@pytest.mark.parametrize("n_acc", [0, 3, 17, 40])
def test_take_accepted_matches_jax(n_acc):
    """A fixed shape whatever the acceptance: the accepted proposals in
    order, cycled on a shortfall, proposal 0 when none is accepted."""
    rng = np.random.default_rng(8 + n_acc)
    z = rng.normal(size=(40, 2))
    accept = np.zeros(40, bool)
    accept[rng.choice(40, n_acc, replace=False)] = True
    with jax.enable_x64(True):
        j = jtoy._take_accepted(jnp.asarray(z), jnp.asarray(accept), 25)
    t = ttoy._take_accepted(torch.as_tensor(z), torch.as_tensor(accept), 25)
    np.testing.assert_array_equal(np_(t), np.asarray(j))


def test_toy_targets_sample():
    """``tests/test_flow_zoo.py``'s sampling checks on the port."""
    g = torch.Generator().manual_seed(9)
    z = torch.as_tensor(normal(10, (32, 2)), dtype=torch.float32)
    for t in (tflows.TwoMoons(), tflows.CircularGaussianMixture(),
              tflows.RingMixture(), tflows.TwoModes(2.0, 0.2),
              tflows.Smiley(0.5)):
        lp = t.log_prob(z)
        assert lp.shape == (32,) and torch.isfinite(lp).all()
    assert tflows.CircularGaussianMixture().sample(100, g, "cpu").shape == \
        (100, 2)
    s = tflows.TwoMoons().sample(64, g, "cpu")
    assert s.shape == (64, 2)
    assert float(tflows.TwoMoons().log_prob(s).mean()) > -3.0
    rings = tflows.RingMixture(2).sample(2000, g, "cpu")
    r = rings.norm(dim=1)
    assert float(((r - 1.0).abs().minimum((r - 2.0).abs()) < 0.4)
                 .double().mean()) > 0.95


# ----- stochastic layers and HAIS --------------------------------------

class JaxGaussian:
    """The unit Gaussian target of ``tests/test_flow_zoo.py`` for JAX."""

    def __init__(self, dim=2):
        self.inner = jflows.DiagGaussian(dim, trainable=False)

    def log_prob(self, z):
        return self.inner.log_prob(z)


def mh_draws(key, steps, shape, dtype):
    """JAX's ``MetropolisHastings.forward`` draws: per step, a proposal
    normal and a uniform."""
    noises, uniforms = [], []
    for k in jax.random.split(key, steps):
        k_prop, k_acc = jax.random.split(k)
        noises.append(np.array(jax.random.normal(k_prop, shape)))
        uniforms.append(np.array(jax.random.uniform(k_acc, shape[:1],
                                                      dtype=dtype)))
    return noises, uniforms


def hmc_draws(key, shape, dtype):
    k_mom, k_acc = jax.random.split(key)
    return (np.array(jax.random.normal(k_mom, shape)),
            np.array(jax.random.uniform(k_acc, shape[:1], dtype=dtype)))


def test_metropolis_hastings_matches_jax_on_the_same_draws():
    steps = 12
    jl = jflows.MetropolisHastings(JaxGaussian(),
                                   jflows.DiagGaussianProposal(2, 0.8), steps)
    tl = tflows.MetropolisHastings(tflows.DiagGaussian(2),
                                   tflows.DiagGaussianProposal(2, 0.8), steps)
    tree = {"proposal": {"log_scale": np.array([-0.3, 0.2])}}
    z0 = 2.0 * normal(11, (64, 2))
    with jax.enable_x64(True):
        key = jax.random.key(12)
        jz, jld = jl.forward(to_jax(tree), jnp.asarray(z0), key)
        noises, uniforms = mh_draws(key, steps, z0.shape, jnp.float64)
    tz, tld = tl.run(to_torch(tree, F64_T), torch.as_tensor(z0),
                     [torch.as_tensor(n) for n in noises],
                     [torch.as_tensor(u) for u in uniforms])
    assert_close(tz, jz)
    assert_close(tld, jld)
    assert bool((tld != 0).any())             # chains moved


@pytest.mark.parametrize("clip", [None, 0.5])
def test_hmc_matches_jax_on_the_same_draws(clip):
    """The leapfrog's gradient by ``torch.autograd.grad`` of the summed
    log density against ``jax.grad`` under ``vmap``, clipped alike."""
    target_j = jflows.TwoModes(1.5, 0.3)
    target_t = tflows.TwoModes(1.5, 0.3)
    jl = jflows.HamiltonianMonteCarlo(target_j, steps=4, dim=2,
                                      max_abs_grad=clip)
    tl = tflows.HamiltonianMonteCarlo(target_t, steps=4, dim=2,
                                      max_abs_grad=clip)
    tree = {"log_step_size": np.log([0.15, 0.1]),
            "log_mass": np.array([0.2, -0.1])}
    z0 = normal(13, (64, 2))
    with jax.enable_x64(True):
        key = jax.random.key(14)
        jz, jld = jl.forward(to_jax(tree), jnp.asarray(z0), key)
        noise, u = hmc_draws(key, z0.shape, jnp.float64)
    tz, tld = tl.run(to_torch(tree, F64_T), torch.as_tensor(z0),
                     torch.as_tensor(noise), torch.as_tensor(u))
    assert_close(tz, jz)
    assert_close(tld, jld)


def test_hmc_step_size_gradient_matches_jax():
    """The trajectory is differentiable in its step size and mass: d/d
    params of the mean final position, against ``jax.grad``."""
    target_j, target_t = jflows.Smiley(0.5), tflows.Smiley(0.5)
    jl = jflows.HamiltonianMonteCarlo(target_j, steps=3, dim=2)
    tl = tflows.HamiltonianMonteCarlo(target_t, steps=3, dim=2)
    tree = {"log_step_size": np.log([0.1, 0.12]),
            "log_mass": np.array([0.1, 0.0])}
    z0 = normal(15, (16, 2))
    with jax.enable_x64(True):
        key = jax.random.key(16)
        noise, _ = hmc_draws(key, z0.shape, jnp.float64)

        def j_mean(p):
            mass = jnp.exp(p["log_mass"])
            step = jnp.exp(p["log_step_size"])
            z, mom = jnp.asarray(z0), jnp.asarray(noise) * jnp.exp(
                0.5 * p["log_mass"])
            for _ in range(3):
                mom = mom + step / 2 * jl._grad_log_p(z)
                z = z + step * mom / mass
                mom = mom + step / 2 * jl._grad_log_p(z)
            return jnp.sum(z)

        j_grad = jax.grad(j_mean)(to_jax(tree))
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in tree.items()}
    # accept every trajectory (u = 0), so z_out is the trajectory's end
    z_out, _ = tl.run(tp, torch.as_tensor(z0), torch.as_tensor(noise),
                      torch.zeros(16, dtype=F64_T) - 1.0)
    grads = torch.autograd.grad(z_out.sum(), [tp["log_mass"],
                                              tp["log_step_size"]])
    assert_close(grads[0], j_grad["log_mass"])
    assert_close(grads[1], j_grad["log_step_size"])


def test_metropolis_hastings_layer_targets_density():
    layer = tflows.MetropolisHastings(tflows.DiagGaussian(2),
                                      tflows.DiagGaussianProposal(2, 1.0),
                                      steps=50)
    g = torch.Generator().manual_seed(30)
    params = layer.init_params(g, device="cpu")
    z0 = 5.0 * torch.randn((512, 2), generator=g)
    z, _ = layer.forward(params, z0, g)
    assert abs(float(z.mean())) < 0.3
    assert 0.6 < float(z.std()) < 1.4


def test_hmc_layer_moves_toward_target():
    layer = tflows.HamiltonianMonteCarlo(tflows.DiagGaussian(2), steps=5,
                                         dim=2)
    g = torch.Generator().manual_seed(33)
    params = layer.init_params(g, device="cpu")
    z0 = 4.0 + torch.randn((256, 2), generator=g)
    z, _ = layer.forward(params, z0, g)
    assert float(z.mean()) < 4.0


class JaxPrior:
    def __init__(self):
        self.inner = jflows.DiagGaussian(2, trainable=False)

    def sample(self, key, n):
        return self.inner.sample(key, n)

    def log_prob(self, z):
        return self.inner.log_prob(z)


class HaisTarget:
    """Unnormalised N(0, 0.5^2 I) times C, log C = 1.7, for either
    package (its arithmetic is the tensors' own)."""

    def log_prob(self, z):
        return -(z ** 2).sum(-1) / (2 * 0.25) + 1.7


HAIS_EXACT = 1.7 + math.log(2 * math.pi * 0.25)


def test_hais_matches_jax_on_the_same_draws():
    betas = tuple(np.linspace(1.0, 0.0, 6))
    jh = jflows.HAIS(betas, JaxPrior(), HaisTarget(), num_leapfrog=3, dim=2,
                     step_size=0.2)
    th = tflows.HAIS(betas, tflows.DiagGaussian(2), HaisTarget(),
                     num_leapfrog=3, dim=2, step_size=0.2)
    with jax.enable_x64(True):
        jp = jh.init_params(jax.random.key(36))
        key = jax.random.key(37)
        js, jw = jh.sample(jp, key, 128)
        k_init, k_hmc = jax.random.split(key)
        s0 = np.asarray(jh.prior.sample(k_init, 128), np.float64)
        draws = [hmc_draws(k, (128, 2), jnp.float64)
                 for k in jax.random.split(k_hmc, len(jp))]
        jp = jax.tree_util.tree_map(np.array, jp)
    tp = th.init_params(dtype=F64_T, device="cpu")
    assert len(tp) == len(jp) == 4
    for a, b in zip(tp, jp):
        assert_close(a["log_step_size"], b["log_step_size"])
    ts, tw = th.sample_from(to_torch(jp, F64_T), torch.as_tensor(s0),
                            [tuple(map(torch.as_tensor, d)) for d in draws])
    # JAX samples its prior in float32 even under x64 (default dtype of
    # the draw), and so do both packages here: the same points
    assert_close(ts, js)
    assert_close(tw, jw)


def test_hais_weights_estimate_normalizer():
    """``tests/test_flow_zoo.py``'s HAIS check on the port: log Z within
    0.25 of the exact 1.7 + log(2 pi 0.25)."""
    betas = tuple(np.linspace(1.0, 0.0, 12))
    hais = tflows.HAIS(betas, tflows.DiagGaussian(2), HaisTarget(),
                       num_leapfrog=3, dim=2, step_size=0.2)
    g = torch.Generator().manual_seed(37)
    params = hais.init_params(g, device="cpu")
    _, log_w = hais.sample(params, 2048, g, "cpu")
    est = float(torch.logsumexp(log_w, 0) - math.log(2048))
    assert abs(est - HAIS_EXACT) < 0.25, (est, HAIS_EXACT)


# ----- VAE -------------------------------------------------------------

def encoder_pair(name):
    if name == "dirac":
        return jflows.Dirac(), tflows.Dirac(), 3
    if name == "uniform":
        return (jflows.UniformEncoder(-1.0, 2.0),
                tflows.UniformEncoder(-1.0, 2.0), 3)
    if name == "const_diag":
        return jflows.ConstDiagGaussian(3), tflows.ConstDiagGaussian(3), 3
    return (jflows.NNDiagGaussian(jflows.MLP((3, 8, 4)), 2),
            tflows.NNDiagGaussian(tflows.MLP((3, 8, 4)), 2), 2)


def jax_encoder_noise(name, key, b, m, d):
    """The raw draw inside JAX's encoder ``sample``."""
    if name == "dirac":
        return np.zeros((b, m, 0))
    if name == "uniform":     # minval + (maxval - minval) * u
        return (np.array(jax.random.uniform(key, (b, m, d), minval=-1.0,
                                              maxval=2.0)) + 1.0) / 3.0
    return np.array(jax.random.normal(key, (b, m, d)))


@pytest.mark.parametrize("name", ["dirac", "uniform", "const_diag", "nn"])
def test_encoder_matches_jax_on_the_same_draws(name):
    je, te, d = encoder_pair(name)
    x = normal(40, (5, 3))
    tree = (random_tree(je.init_params(jax.random.key(0)), 41, 0.4)
            if hasattr(je, "init_params") else None)
    with jax.enable_x64(True):
        key = jax.random.key(42)
        jz, jq = je.sample(to_jax(tree) if tree else None, key,
                           jnp.asarray(x), 4)
        noise = jax_encoder_noise(name, key, 5, 4, d)
        j_lp = je.log_prob(to_jax(tree) if tree else None, jz,
                           jnp.asarray(x))
    tp = to_torch(tree, F64_T) if tree else None
    tz, tq = te.from_noise(tp, torch.as_tensor(x), torch.as_tensor(noise))
    assert_close(tz, jz, rtol=1e-10, atol=1e-10)
    assert_close(tq, jq)
    assert_close(te.log_prob(tp, torch.as_tensor(np.asarray(jz)),
                             torch.as_tensor(x)), j_lp)
    z, q = te.sample(tp, torch.as_tensor(x), 4,
                     torch.Generator().manual_seed(1))
    assert z.shape == tuple(jz.shape) and q.shape == (5, 4)


def vaes(decoder):
    def build(m, **kw):
        dec = {"gaussian": lambda: m.NNDiagGaussianDecoder(
                   m.MLP((2, 8, 6)), 3),
               "bernoulli": lambda: m.NNBernoulliDecoder(m.MLP((2, 8, 3))),
               "none": lambda: None}[decoder]()
        return m.NormalizingFlowVAE(
            m.DiagGaussian(2), m.NNDiagGaussian(m.MLP((3, 8, 4)), 2),
            (m.Planar(2, act="leaky_relu"), m.AffineConstFlow(2),
             m.Radial(2)), dec, **kw)

    jv = build(jflows)
    tv = build(tflows, device="cpu").to(F64_T)
    tree = random_tree(jv.init_params(jax.random.key(0)), 43, 0.3)
    return jv, params_from_jax(tree, tv), tree


@pytest.mark.parametrize("decoder", ["gaussian", "bernoulli", "none"])
def test_flow_vae_matches_jax_and_carries_its_tree(decoder):
    jv, tv, tree = vaes(decoder)
    x = (normal(44, (5, 3)) > 0).astype(np.float64) if \
        decoder == "bernoulli" else normal(44, (5, 3))
    with jax.enable_x64(True):
        key = jax.random.key(45)
        j = jv.forward(to_jax(tree), key, jnp.asarray(x), num_samples=3)
        noise = np.array(jax.random.normal(key, (5, 3, 2)))
    t = tv.forward_from_noise(torch.as_tensor(x), torch.as_tensor(noise))
    for a, b in zip(t, j):
        assert_close(a.detach(), b)
    back = params_to_jax(tv)
    assert set(back) == {"encoder", "flows", "decoder"}
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    z, log_q, log_p = tv(torch.as_tensor(x), 2,
                         torch.Generator().manual_seed(3))
    assert z.shape == (5, 2, 2) and log_q.shape == log_p.shape == (5, 2)


# ----- models ----------------------------------------------------------

def test_context_affine_coupling_and_conditional_flow_match_jax():
    def layers(m):
        return (m.ContextAffineCoupling(4, 3, 8),
                m.ContextAffineCoupling(4, 3, 8, flip=True))

    jl = layers(jflows)
    jm = jflows.ConditionalNormalizingFlow(
        jflows.UniformParticle(2, 2, 3.0), jl)
    tm = ConditionalNormalizingFlow(
        tflows.UniformParticle(2, 2, 3.0),
        [ParamLayer(l, device="cpu") for l in layers(tflows)],
        device="cpu").to(F64_T)
    tree = random_tree(jm.init_params(jax.random.key(0)), 46, 0.4)
    params_from_jax(tree, tm)
    x = np.random.default_rng(47).uniform(-2.5, 2.5, size=(16, 4))
    ctx = normal(48, (16, 3))
    tx, tc = torch.as_tensor(x), torch.as_tensor(ctx)
    with jax.enable_x64(True):
        jp, jx, jc = to_jax(tree), jnp.asarray(x), jnp.asarray(ctx)
        for i in range(2):
            for direction in ("forward", "inverse"):
                j = getattr(jl[i], direction)(jp[i], jx, context=jc)
                t = getattr(tm.layers[i], direction)(tx, tc)
                for a, b in zip(t, j):
                    assert_close(a.detach(), b)
        j_lp = jm.log_prob(jp, jx, jc)
    assert_close(tm.log_prob(tx, tc).detach(), j_lp)


class JaxCondBase:
    """``tests/test_residual_image.py``'s class-shifted Gaussian."""

    def __init__(self, dim, num_classes):
        self.inner = jflows.DiagGaussian(dim, trainable=False)
        self.num_classes = num_classes

    def log_prob(self, z, y):
        return self.inner.log_prob(
            z - y @ jnp.arange(self.num_classes, dtype=z.dtype)[:, None])

    def sample(self, key, n, y):
        return self.inner.sample(key, n) + y @ jnp.arange(
            self.num_classes, dtype=jnp.float32)[:, None]


class TorchCondBase:
    def __init__(self, dim, num_classes):
        self.inner = tflows.DiagGaussian(dim)
        self.num_classes = num_classes

    def log_prob(self, z, y):
        return self.inner.log_prob(z - y @ torch.arange(
            self.num_classes, dtype=z.dtype)[:, None])

    def sample(self, n, y, generator=None):
        return self.inner.sample(n, generator, y.device) + y.float() @ \
            torch.arange(self.num_classes, dtype=torch.float32)[:, None]


@pytest.mark.parametrize("base", ["class_shift", "class_cond_diag"])
def test_class_cond_flow_matches_jax(base):
    """The dense half of ``tests/test_residual_image.py:112-125``."""
    d = 4

    def layers(m):
        return (m.AffineConstFlow(d), m.AffineCouplingBlock(
            m.MLP((d // 2, 8, d))))

    if base == "class_shift":
        jb, tb = JaxCondBase(d, 3), TorchCondBase(d, 3)
    else:
        jb, tb = (jflows.ClassCondDiagGaussian(d, 3),
                  tflows.ClassCondDiagGaussian(d, 3))
    jm = jflows.ClassCondFlow(jb, layers(jflows))
    tm = ClassCondFlow(tb, [ParamLayer(l, device="cpu")
                            for l in layers(tflows)], device="cpu").to(F64_T)
    tree = random_tree(jm.init_params(jax.random.key(12)), 49, 0.4)
    params_from_jax(tree, tm)
    x = normal(50, (6, d))
    y = np.eye(3)[[0, 1, 2, 0, 1, 2]]
    with jax.enable_x64(True):
        jp, jx, jy = to_jax(tree), jnp.asarray(x), jnp.asarray(y)
        j_lp = jm.log_prob(jp, jx, jy)
        j_loss = jm.forward_kld(jp, jx, jy)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    assert_close(tm.log_prob(tx, ty).detach(), j_lp)
    assert_close(tm.forward_kld(tx, ty).detach(), j_loss)
    s = tm.sample(6, ty, torch.Generator().manual_seed(14))
    assert s.shape == (6, d) and torch.isfinite(s).all()


# ----- the slice: the circular autoregressive flow's big move ----------

N, C = 3, 96
WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def slice_flows(hb, seed, dtype=torch.float32):
    """JAX's and the port's K=2 circular autoregressive flow over
    ``UniformParticle(3, 2, hb)``, all 6 coordinates circular, with one
    seeded tree."""
    def layer(m):
        return m.CircularAutoregressiveRationalQuadraticSpline(
            2 * N, 2, 16, ind_circ=tuple(range(2 * N)), num_bins=4,
            tail_bound=hb)

    jm = jflows.NormalizingFlow(jflows.UniformParticle(N, 2, hb),
                                (layer(jflows), layer(jflows)))
    tm = NormalizingFlow(tflows.UniformParticle(N, 2, hb),
                         [ParamLayer(layer(tflows), device="cpu")
                          for _ in range(2)], device="cpu").to(dtype)
    tree = random_tree(jm.init_params(jax.random.key(0)), seed, 0.25)
    return jm, params_from_jax(tree, tm), tree


def test_circular_autoregressive_flow_matches_jax_in_float64():
    hb = 5.0
    jm, tm, tree = slice_flows(hb, 51, F64_T)
    x = np.random.default_rng(52).uniform(-hb, hb, size=(32, 2 * N))
    with jax.enable_x64(True):
        jp, jx = to_jax(tree), jnp.asarray(x)
        j_lp = jm.log_prob(jp, jx)
        z = np.array(jax.random.uniform(jax.random.key(3), (32, 2 * N),
                                          jnp.float64, -hb, hb))
        j_x, j_ld = jm.forward_and_log_det(jp, jnp.asarray(z))
    with torch.no_grad():
        assert_close(tm.log_prob(torch.as_tensor(x)), j_lp)
        t_x, t_ld = tm.forward_and_log_det(torch.as_tensor(z))
        assert_close(t_x, j_x)
        assert_close(t_ld, j_ld)
        back, ld_inv = tm.inverse_and_log_det(t_x)
    assert_close(back, z, rtol=1e-8, atol=1e-8)
    assert_close(t_ld + ld_inv, np.zeros(32), rtol=1e-8, atol=1e-8)


def test_circular_autoregressive_big_move_round_matches_jax():
    """JAX's ``nf_big_moves`` against the port's ``apply_big_moves`` on
    JAX's draws (its base points and uniforms, rebuilt from the chains'
    keys), in float32."""
    jspec = jops.SystemSpec.create(N, jops.Box.from_density(N, 0.03),
                                   **WELLS)
    tspec = tops.SystemSpec.create(N, tops.Box.from_density(N, 0.03),
                                   **WELLS)
    hb = tspec.box.size_x / 2.0
    jm, tm, tree = slice_flows(hb, 53)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    # chains spread over the box, so that the energy changes are of
    # order one and the decisions mixed
    pos = np.random.default_rng(54).uniform(
        0.0, 2 * hb, size=(C, N, 2)).astype(np.float32)
    jstate = jmcmc.init_chain_state(jspec, jnp.asarray(pos),
                                    jax.random.key(55), 0.65)
    tstate = tmcmc.chain_state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if f != "key"}, 0, "cpu")
    jres = jmcmc.nf_big_moves(jspec, 1.0, jstate, jm, jp, hb)
    keys = jax.vmap(jax.random.split)(jstate.key)
    k_prop = jax.random.fold_in(keys[0, 1], 0x9E3779B9)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys[:, 1]))
    z = np.array(jm.base.sample(k_prop, C))
    j_new, j_lq_new = jm.sample_and_log_prob(jp, k_prop, C)

    with torch.no_grad():
        t_new, t_ld = tm.forward_and_log_det(torch.as_tensor(z))
        t_lq_new = tm.base.log_prob(torch.as_tensor(z)) - t_ld
    np.testing.assert_allclose(np_(t_new), np.asarray(j_new), rtol=0,
                               atol=PROP_ATOL)
    np.testing.assert_allclose(np_(t_lq_new), np.asarray(j_lq_new), **LQ_TOL)
    props = tmcmc.to_box_frame(t_new, N, hb)
    tres = tmcmc.apply_big_moves(tspec, 1.0, tstate, props, t_lq_new, tm, hb,
                                 torch.as_tensor(u))

    # JAX's energies on the port's proposals: LJ repulsion turns the
    # flows' float32 rounding into larger energy differences
    energy = jax.vmap(lambda q: jops.total_energy_virial(jspec, q)[0])
    t_e = np_(tres.proposal_energy)
    np.testing.assert_allclose(t_e, np.asarray(energy(jnp.asarray(
        np_(props)))), rtol=1e-5, atol=1e-4)
    j_ratio = np.asarray(jres.ratio_log)
    t_ratio = np_(tres.ratio_log)
    finite = np.isfinite(j_ratio)
    np.testing.assert_array_equal(np.isfinite(t_ratio), finite)
    j_e = np.asarray(jres.proposal_energy, np.float64)[finite]
    t_ef = t_e[finite].astype(np.float64)
    j_rest = j_ratio[finite] + j_e
    t_rest = t_ratio[finite].astype(np.float64) + t_ef
    scale = np.abs(j_rest) + np.abs(j_e)
    assert np.all(np.abs(t_rest - j_rest) <= 1e-5 * scale + 1e-4), (
        np.max(np.abs(t_rest - j_rest) / (scale + 10.0)))
    # ratio_log itself, where the energies agree to float32 rounding
    calm = np.abs(t_ef - j_e) <= 1e-4 + 1e-5 * np.abs(j_e)
    assert calm.sum() > C // 2
    np.testing.assert_allclose(t_ratio[finite][calm], j_ratio[finite][calm],
                               rtol=1e-5, atol=2e-4)
    j_acc = np.asarray(jres.accepted)
    t_acc = np_(tres.accepted)
    np.testing.assert_array_equal(t_acc, u < np.exp(t_ratio))
    lo = np.minimum(np.exp(j_ratio), np.exp(t_ratio)) - NEAR_TIE
    hi = np.maximum(np.exp(j_ratio), np.exp(t_ratio)) + NEAR_TIE
    near = (lo <= u) & (u <= hi)
    np.testing.assert_array_equal(t_acc[~near], j_acc[~near])
    assert 0 < t_acc.sum() < C                   # the decisions are mixed
    np.testing.assert_array_equal(np_(tres.state.attempts),
                                  np.asarray(jres.state.attempts))
    # the port's own round draws from a generator; its paired and
    # separate forms (one flow of ParamLayers: both separate) agree
    out = [tmcmc.nf_big_moves(tspec, 1.0, tstate, tm, hb,
                              torch.Generator().manual_seed(5), paired=p)
           for p in (True, False)]
    np.testing.assert_array_equal(np_(out[0].ratio_log),
                                  np_(out[1].ratio_log))

