"""The port's residual and image flows (``flowstate_tpu_torch.flows``:
``residual``, ``image``, ``GlowBase``, ``MultiscaleFlow``) against the JAX
package's, on the same seeded weights and inputs.

Weights are a numpy tree shaped like the JAX layer's own (its init, or
seeded normals), handed to JAX inside ``jax.enable_x64`` and to the port
as float64 tensors or carried by ``params_from_jax``.  The estimators'
noise is JAX's, rebuilt from its keys (the Rademacher probes and the
roulette draw) and handed to the port as tensors.  Tolerances:

* float64 on both sides, the same arithmetic: 1e-10 (``F64``); JAX's
  image convolutions ask for float32 results (``preferred_element_type``)
  and raise on float64 inputs (ROADMAP R15), so the fixture
  ``jax_convs_in_float64`` drops that argument while JAX runs, and
  ``test_jax_image_convs_raise_in_float64_r15`` shows the raise;
* gradients against ``jax.grad`` in float64: 1e-9 (``GRAD``), the
  fixed-point inverse's 51 net passes and the series' second derivatives
  adding rounding;
* one Adam step against JAX's: ``TOL`` of ``test_torch_training.py``;
* the port's own round trips in float64: 1e-8, and at float32's
  rounding 1e-4;
* the estimators' invariants (series and the roulette mean near exact),
  the roulette helpers' means: the bounds of ``tests/test_residual_
  image.py``.

Sizes are small: 3 or 4 features, hidden 16, images 4 x 4 to 8 x 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowstate_tpu.flows as jflows
from flowstate_tpu.flows import residual as jresidual
import flowstate_tpu_torch.flows as tflows
from flowstate_tpu_torch.flows import (
    MultiscaleFlow, NormalizingFlow, ParamLayer, params_from_jax,
    params_to_jax, tree_map,
)
from flowstate_tpu_torch.flows import residual as tresidual

from test_torch_flow import F64, np_, random_tree, to_jax, to_torch
from test_torch_training import (
    TOL, assert_params_equal, jax_stepper, port_stepper,
)

torch.set_num_threads(1)

D, B, HIDDEN = 3, 5, 16
F64_T = torch.float64
GRAD = dict(rtol=1e-9, atol=1e-9)
ROUND_TRIP = dict(rtol=1e-8, atol=1e-8)


@pytest.fixture(autouse=True)
def jax_convs_in_float64(request, monkeypatch):
    """JAX's image convs without their float32 results (R15), except in
    the test that shows them."""
    if request.node.originalname == "test_jax_image_convs_raise_in_float64_r15":
        return
    conv = jax.lax.conv_general_dilated

    def float64_conv(*args, preferred_element_type=None, **kwargs):
        return conv(*args, **kwargs)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", float64_conv)


def assert_close(got, want, **tol):
    got = np_(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or F64))


def jax64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def shapes(layer):
    """Zeros shaped like ``layer``'s JAX tree, traced without running
    (JAX's eager init compiles each of its operations)."""
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape),
        jax.eval_shape(layer.init_params, jax.random.key(0)))


# ----- helpers and activations -------------------------------------------

@pytest.mark.parametrize("name", ["lipswish", "leaky_elu", "asym_squash"])
def test_activations_match_jax(name):
    x = np.linspace(-5.0, 5.0, 101)
    with jax.enable_x64(True):
        want = getattr(jflows, name)(jnp.asarray(x))
    assert_close(getattr(tflows, name)(torch.as_tensor(x)), want)
    if name == "asym_squash":
        got = np_(tflows.asym_squash(torch.as_tensor(x)))
        assert np.all((got > 1.0) & (got < 5.0)) and np.all(np.diff(got) > 0)


def test_roulette_helpers_match_jax():
    """The geometric draw on JAX's own uniforms is JAX's draw; the
    1 - CDF helpers equal JAX's; the port's draws have the right means
    (``tests/test_residual_image.py``'s bound, 4000 draws)."""
    key = jax.random.key(10)
    want = np.asarray(jflows.geometric_sample(key, 0.5, (4000,)))
    u = jax.random.uniform(key, (4000,),
                           minval=jnp.finfo(jnp.float32).tiny)
    got = tresidual.geometric_from_uniform(torch.as_tensor(np.asarray(u)),
                                           0.5)
    np.testing.assert_array_equal(np_(got), want)
    for k in range(0, 9):
        for offset in (0, 2):
            assert tresidual.geometric_1mcdf(0.3, k, offset) == \
                jresidual.geometric_1mcdf(0.3, k, offset)
            assert tresidual.poisson_1mcdf(2.0, k, offset) == \
                jresidual.poisson_1mcdf(2.0, k, offset)
    g = torch.Generator().manual_seed(0)
    geo = np_(tflows.geometric_sample(g, 0.5, (4000,), "cpu"))
    poi = np_(tflows.poisson_sample(g, 2.0, (4000,), "cpu"))
    assert geo.dtype == poi.dtype == np.int32 and geo.min() >= 1
    assert abs(geo.mean() - 2.0) < 0.15 and abs(poi.mean() - 2.0) < 0.15


def test_batch_jacobian_and_trace_match_jax():
    rng = np.random.default_rng(12)
    w, x = rng.normal(size=(D, D)), rng.normal(size=(4, D))
    with jax.enable_x64(True):
        jac = jflows.batch_jacobian(lambda v: jnp.tanh(v @ jnp.asarray(w)),
                                    jnp.asarray(x))
        tr = jflows.batch_trace(jac)
    tw = torch.as_tensor(w)
    got = tflows.batch_jacobian(lambda v: torch.tanh(v @ tw),
                                torch.as_tensor(x))
    assert_close(got, jac)
    assert_close(tflows.batch_trace(got), tr)


# ----- LipschitzMLP and Residual -----------------------------------------

def lipschitz_tree(seed, channels=(D, HIDDEN, D), coeff=0.9, scale=2.0):
    """JAX's init, the weights scaled by ``scale`` (so the normalisation
    binds), then 20 power-iteration steps of ``u``."""
    net = jflows.LipschitzMLP(channels, coeff=coeff)
    with jax.enable_x64(True):
        p = to_jax(net.init_params(jax.random.key(seed)))
        p = [{**layer, "w": layer["w"] * scale} for layer in p]
        return jax64(net.update_lipschitz(p, 20))


def test_lipschitz_mlp_matches_jax_and_contracts():
    tree = lipschitz_tree(0)
    x = np.random.default_rng(1).normal(size=(64, D))
    y = x + 0.3 * np.random.default_rng(2).normal(size=(64, D))
    jnet = jflows.LipschitzMLP((D, HIDDEN, D), coeff=0.9)
    tnet = tflows.LipschitzMLP((D, HIDDEN, D), coeff=0.9)
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        assert_close(tnet.apply(tp, torch.as_tensor(x)),
                     jnet.apply(to_jax(tree), jnp.asarray(x)))
        j_upd = jnet.update_lipschitz(to_jax(tree), 7)
    t_upd = tnet.update_lipschitz(tp, 7)
    for a, b in zip(t_upd, j_upd):
        assert_close(a["u"], b["u"])
        assert a["w"] is not None and not a["u"].requires_grad
    fx, fy = np_(tnet.apply(tp, torch.as_tensor(x))), np_(
        tnet.apply(tp, torch.as_tensor(y)))
    ratios = (np.linalg.norm(fx - fy, axis=1)
              / np.linalg.norm(x - y, axis=1))
    assert np.all(ratios < 1.0), ratios.max()


def test_lipschitz_mlp_init_draws_unit_vectors():
    tnet = tflows.LipschitzMLP((D, HIDDEN, HIDDEN, D))
    params = tnet.init_params(torch.Generator().manual_seed(3),
                              dtype=F64_T, device="cpu")
    assert [tuple(p["w"].shape) for p in params] == [
        (D, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, D)]
    for p in params:
        assert abs(float(torch.linalg.norm(p["u"])) - 1.0) < 1e-12
        bound = 1.0 / np.sqrt(p["w"].shape[0])
        assert float(p["w"].abs().max()) <= bound


def residual_pair(estimator, reverse=True, **kw):
    make = dict(estimator=estimator, reverse=reverse, dim=D,
                n_trace_samples=2, **kw)
    return (jflows.Residual(jflows.LipschitzMLP((D, HIDDEN, D), coeff=0.9),
                            **make),
            tflows.Residual(tflows.LipschitzMLP((D, HIDDEN, D), coeff=0.9),
                            **make))


def jax_noise(layer, key, shape):
    """JAX's draws inside the estimator, rebuilt from ``key``: ``(eps,
    n)`` as numpy, ``n`` None for ``series``."""
    with jax.enable_x64(True):
        if layer.estimator == "series":
            eps = jax.random.rademacher(key, (layer.n_trace_samples, *shape),
                                        dtype=jnp.float64)
            return np.asarray(eps), None
        k_n, k_eps = jax.random.split(key)
        n = (jflows.geometric_sample(k_n, layer.geom_p)
             if layer.n_dist == "geometric"
             else jflows.poisson_sample(k_n, layer.lamb))
        eps = jax.random.rademacher(k_eps, (layer.n_trace_samples, *shape),
                                    dtype=jnp.float64)
        return np.asarray(eps), np.asarray(n)


def torch_noise(noise):
    eps, n = noise
    return torch.as_tensor(eps), None if n is None else torch.as_tensor(n)


ESTIMATORS = {
    "exact": dict(),
    "series": dict(),
    "unbiased_geometric": dict(n_power_series=10),
    "unbiased_poisson": dict(n_dist="poisson", n_power_series=10),
}


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_residual_matches_jax_on_its_noise(name, reverse):
    """Both directions and log-dets against JAX's with JAX's noise; the
    port's round trip."""
    jl, tl = residual_pair(name.split("_")[0], reverse, **ESTIMATORS[name])
    tree = {"net": lipschitz_tree(4)}
    z = np.random.default_rng(5).normal(size=(B, D))
    key = jax.random.key(6)
    noise = (None if name == "exact"
             else torch_noise(jax_noise(jl, key, z.shape)))
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        for direction in ("forward", "inverse"):
            j_out, j_ld = getattr(jl, direction)(to_jax(tree),
                                                 jnp.asarray(z), key=key)
            t_out, t_ld = getattr(tl, direction)(tp, torch.as_tensor(z),
                                                 noise=noise)
            assert t_out.dtype == t_ld.dtype == F64_T
            assert_close(t_out, j_out)
            assert_close(t_ld, j_ld)
    if name == "exact":
        y, ld = tl.forward(tp, torch.as_tensor(z))
        back, ld_inv = tl.inverse(tp, y)
        assert_close(back, z, **ROUND_TRIP)
        assert_close(ld + ld_inv, np.zeros(B), **ROUND_TRIP)


def test_series_default_probes_are_fixed_and_unbiased_needs_noise():
    """Without noise ``series`` takes the same probes at every call (JAX's
    ``key(0)``); ``unbiased`` refuses to run without a generator or noise,
    and an unknown estimator is refused, in both packages."""
    jl, tl = residual_pair("series")
    tp = to_torch({"net": lipschitz_tree(7)}, F64_T)
    z = torch.as_tensor(np.random.default_rng(8).normal(size=(B, D)))
    a, b = tl.inverse(tp, z)[1], tl.inverse(tp, z)[1]
    assert torch.equal(a, b)
    _, tu = residual_pair("unbiased")
    with pytest.raises(ValueError):
        tu.inverse(tp, z)
    with pytest.raises(ValueError):
        residual_pair("nope")[1].inverse(tp, z)
    ju = residual_pair("unbiased")[0]
    jp = jflows.Residual(ju.net).init_params(jax.random.key(0))
    with pytest.raises(ValueError):
        ju.inverse(jp, jnp.zeros((2, D)))
    g = torch.Generator().manual_seed(1)
    assert torch.isfinite(tu.inverse(tp, z, generator=g)[1]).all()


@pytest.mark.parametrize("name", ["exact", "series", "unbiased_geometric"])
def test_gradients_through_the_estimators_match_jax_grad(name):
    """``jax.grad`` of a loss through both directions (the fixed-point
    inverse and the map) and the log-det, on JAX's noise: every leaf's
    gradient, ``u`` too."""
    jl, tl = residual_pair(name.split("_")[0], **ESTIMATORS[name])
    tree = {"net": lipschitz_tree(9)}
    z = np.random.default_rng(10).normal(size=(B, D))
    key = jax.random.key(11)
    noise = (None if name == "exact"
             else torch_noise(jax_noise(jl, key, z.shape)))

    def j_loss(p):
        x, ld = jl.forward(p, jnp.asarray(z), key=key)
        y, ld2 = jl.inverse(p, x ** 2, key=key)
        return jnp.sum(ld) + jnp.sum(jnp.sin(y)) + jnp.sum(ld2 ** 2)

    with jax.enable_x64(True):
        j_val, j_grad = jax.jit(jax.value_and_grad(j_loss))(to_jax(tree))
    layer = ParamLayer(tl, device="cpu").double()
    params_from_jax(tree, layer)
    x, ld = layer(torch.as_tensor(z), noise=noise)
    y, ld2 = layer.inverse(x ** 2, noise=noise)
    loss = torch.sum(ld) + torch.sum(torch.sin(y)) + torch.sum(ld2 ** 2)
    loss.backward()
    assert_close(loss.detach(), j_val, **GRAD)
    grads = tree_map(lambda p: np_(p.grad), layer.params.tree())
    theirs = jax.tree_util.tree_leaves(j_grad)
    ours = jax.tree_util.tree_leaves(grads)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert_close(a, b, **GRAD)
    assert all(np.any(g["u"] != 0) for g in grads["net"])


def test_series_estimator_close_to_exact():
    """``tests/test_residual_image.py``'s bound (0.1) at 20 terms and 64
    probes, on the port alone."""
    net = tflows.LipschitzMLP((D + 1, 32, D + 1), coeff=0.7)
    tp = {"net": net.update_lipschitz(net.init_params(
        torch.Generator().manual_seed(5), dtype=F64_T, device="cpu"), 20)}
    z = torch.randn(16, D + 1, generator=torch.Generator().manual_seed(6),
                    dtype=F64_T)
    _, exact = tflows.Residual(net, estimator="exact", dim=D + 1).inverse(
        tp, z)
    _, series = tflows.Residual(net, estimator="series", n_power_series=20,
                                n_trace_samples=64).inverse(tp, z)
    assert_close(series, np_(exact), rtol=0, atol=0.1)


def test_unbiased_estimator_mean_close_to_exact():
    """The roulette estimator averaged over 256 draws of the port's
    generator within 0.05 of exact, geometric and Poisson
    (``tests/test_residual_image.py``'s bound)."""
    net = tflows.LipschitzMLP((D + 1, 32, D + 1), coeff=0.6)
    tp = {"net": net.update_lipschitz(net.init_params(
        torch.Generator().manual_seed(7), dtype=F64_T, device="cpu"), 20)}
    z = torch.randn(4, D + 1, generator=torch.Generator().manual_seed(8),
                    dtype=F64_T)
    _, exact = tflows.Residual(net, estimator="exact", dim=D + 1).inverse(
        tp, z)
    g = torch.Generator().manual_seed(9)
    for extra in (dict(geom_p=0.5), dict(n_dist="poisson", lamb=2.0)):
        layer = tflows.Residual(net, estimator="unbiased", n_power_series=24,
                                n_trace_samples=4, n_exact_terms=2, **extra)
        with torch.no_grad():
            lds = torch.stack([layer.inverse(tp, z, generator=g)[1]
                               for _ in range(256)])
        assert_close(lds.mean(0), np_(exact), rtol=0, atol=0.05)


def test_series_log_det_on_images_sums_every_axis_r16():
    """On images JAX's power series sums ``v * e`` over the last axis only
    and fails to broadcast (R16); the port sums every axis but the batch,
    which on the flattened input is the vector estimator's value."""
    jnet = jflows.LipschitzCNN((2, 4, 2), (3, 3), (4, 4), coeff=0.9)
    tnet = tflows.LipschitzCNN((2, 4, 2), (3, 3), (4, 4), coeff=0.9)
    tree = random_tree(shapes(jnet), 12, 0.3)
    z = np.random.default_rng(13).normal(size=(3, 2, 4, 4))
    jl = jflows.Residual(jnet, estimator="series")
    with jax.enable_x64(True), pytest.raises(ValueError):
        jax.jit(jl.inverse)({"net": to_jax(tree)}, jnp.asarray(z),
                            key=jax.random.key(0))
    tl = tflows.Residual(tnet, estimator="series", n_trace_samples=2)
    tp = {"net": to_torch(tree, F64_T)}
    eps = torch.as_tensor(np.random.default_rng(14).choice(
        [-1.0, 1.0], size=(2, *z.shape)))
    _, ld = tl.inverse(tp, torch.as_tensor(z), noise=(eps, None))

    class Flat:
        def apply(self, params, v):
            return tnet.apply(params, v.reshape(z.shape)).reshape(3, -1)

    flat = tflows.Residual(Flat(), estimator="series", n_trace_samples=2)
    _, ld_flat = flat.inverse(tp, torch.as_tensor(z).reshape(3, -1),
                              noise=(eps.reshape(2, 3, -1), None))
    assert ld.shape == (3,)
    assert_close(ld, np_(ld_flat), rtol=1e-12, atol=1e-12)


# ----- LipschitzCNN -------------------------------------------------------

def test_lipschitz_cnn_matches_jax_and_contracts():
    jnet = jflows.LipschitzCNN((2, 8, 2), (3, 3), (6, 6), coeff=0.9)
    tnet = tflows.LipschitzCNN((2, 8, 2), (3, 3), (6, 6), coeff=0.9)
    rng = np.random.default_rng(40)
    tree = jax64(jnet.init_params(jax.random.key(40)))
    tree = [{**layer, "b": rng.normal(0, 0.1, layer["b"].shape)}
            for layer in tree]
    x = rng.normal(size=(4, 2, 6, 6))
    y = rng.normal(size=(4, 2, 6, 6))
    with jax.enable_x64(True):
        want = jnet.apply(to_jax(tree), jnp.asarray(x))
        j_upd = jax64(jnet.update_lipschitz(to_jax(tree), 20))
    tp = to_torch(tree, F64_T)
    assert_close(tnet.apply(tp, torch.as_tensor(x)), want)
    t_upd = tnet.update_lipschitz(tp, 20)
    for a, b in zip(t_upd, j_upd):
        assert_close(a["u"], b["u"])
    fx = np_(tnet.apply(t_upd, torch.as_tensor(x))).reshape(4, -1)
    fy = np_(tnet.apply(t_upd, torch.as_tensor(y))).reshape(4, -1)
    ratios = (np.linalg.norm(fx - fy, axis=1)
              / np.linalg.norm((x - y).reshape(4, -1), axis=1))
    assert np.all(ratios < 1.0)
    params = tnet.init_params(torch.Generator().manual_seed(1),
                              dtype=F64_T, device="cpu")
    assert [tuple(p["u"].shape) for p in params] == [(1, 8, 6, 6),
                                                     (1, 2, 6, 6)]


# ----- image layers -------------------------------------------------------

IMAGE_LAYERS = {
    "convnet": (lambda m: m.ConvNet2d((2, 8, 8, 4), kernel_size=(3, 1, 3),
                                      leaky=0.1), (3, 2, 6, 6)),
    "conv_residual_net": (lambda m: m.ConvResidualNet(2, 5, 8, 2),
                          (3, 2, 6, 6)),
}


@pytest.mark.parametrize("name", sorted(IMAGE_LAYERS))
def test_image_nets_match_jax(name):
    make, shape = IMAGE_LAYERS[name]
    jn, tn = make(jflows), make(tflows)
    tree = random_tree(shapes(jn), 20, 0.3)
    x = np.random.default_rng(21).normal(size=shape)
    with jax.enable_x64(True):
        want = jn.apply(to_jax(tree), jnp.asarray(x))
    assert_close(tn.apply(to_torch(tree, F64_T), torch.as_tensor(x)), want)


def test_image_net_inits_follow_jax():
    """Zero final conv (ConvNet2d), near-identity residual blocks
    (ConvResidualNet's second convs within 1e-3), default bounds."""
    g = torch.Generator().manual_seed(0)
    net = tflows.ConvNet2d((2, 8, 8, 4))
    params = net.init_params(g, dtype=F64_T, device="cpu")
    x = torch.randn(3, 2, 8, 8, generator=g, dtype=F64_T)
    assert torch.equal(net.apply(params, x), torch.zeros(3, 4, 8, 8,
                                                         dtype=F64_T))
    assert float(params[0]["w"].abs().max()) <= 1 / np.sqrt(2 * 9)
    res = tflows.ConvResidualNet(2, 5, 8, 2)
    p = res.init_params(g, dtype=F64_T, device="cpu")
    assert all(float(b["c2"]["w"].abs().max()) <= 1e-3 for b in p["blocks"])
    zero = {**p, "blocks": [{**b, "c2": tree_map(torch.zeros_like, b["c2"])}
                            for b in p["blocks"]]}
    x = torch.randn(3, 2, 6, 6, generator=g, dtype=F64_T)
    assert_close(res.apply(p, x), np_(res.apply(zero, x)), rtol=0, atol=0.05)


def test_actnorm_image_matches_jax_and_whitens():
    rng = np.random.default_rng(11)
    z = 2.0 + 1.5 * rng.normal(size=(64, 3, 5, 5))
    jl, tl = jflows.ActNormImage(3), tflows.ActNormImage(3)
    with jax.enable_x64(True):
        jp = jl.init_params_from_data(jnp.asarray(z))
        j_fwd = jl.forward(jp, jnp.asarray(z))
        j_inv = jl.inverse(jp, jnp.asarray(z))
    tp = tl.init_params_from_data(torch.as_tensor(z))
    for k in ("s", "t"):
        assert_close(tp[k], jp[k])
    for got, want in zip(tl.forward(tp, torch.as_tensor(z)) +
                         tl.inverse(tp, torch.as_tensor(z)), j_fwd + j_inv):
        assert_close(got, want)
    y = np_(tl.forward(tp, torch.as_tensor(z))[0])
    np.testing.assert_allclose(y.mean(axis=(0, 2, 3)), 0.0, atol=1e-10)
    np.testing.assert_allclose(y.std(axis=(0, 2, 3)), 1.0, atol=1e-5)


GLOW = {
    "sigmoid": dict(),
    "exp": dict(scale_map="exp"),
    "shift": dict(scale=False),
    "odd_channels": dict(channels=3),
    "dense_1x1": dict(use_lu=False, leaky=0.2),
}


@pytest.mark.parametrize("name", sorted(GLOW))
def test_glow_block_matches_jax(name):
    kw = {"channels": 4, "hidden_channels": 8, **GLOW[name]}
    jl, tl = jflows.GlowBlock(**kw), tflows.GlowBlock(**kw)
    scale = 0.1 if name == "exp" else 0.3
    tree = random_tree(shapes(jl), 22, scale)
    if kw.get("use_lu", True):   # the LU diagonal's signs are +-1
        tree["conv1x1"]["sign_upper_diag"] = np.sign(
            tree["conv1x1"]["sign_upper_diag"])
    z = np.random.default_rng(23).normal(size=(2, kw["channels"], 4, 4))
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        for direction in ("forward", "inverse"):
            j_out, j_ld = getattr(jl, direction)(to_jax(tree), jnp.asarray(z))
            t_out, t_ld = getattr(tl, direction)(tp, torch.as_tensor(z))
            assert_close(t_out, j_out, rtol=1e-10, atol=1e-9)
            assert_close(t_ld, j_ld)
    y, ld = tl.forward(tp, torch.as_tensor(z))
    back, ld_inv = tl.inverse(tp, y)
    assert_close(back, z, **ROUND_TRIP)
    assert_close(ld + ld_inv, np.zeros(2), **ROUND_TRIP)


def test_glow_block_identity_at_init_up_to_the_sigmoid():
    """At init the coupling's net outputs zeros, so the scale is
    sigmoid(2) everywhere; the float32 round trip within 1e-4."""
    layer = ParamLayer(tflows.GlowBlock(4, 8),
                       torch.Generator().manual_seed(9), device="cpu")
    z = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(10))
    y, ld = layer(z)
    back, ld_inv = layer.inverse(y)
    assert_close(back, np_(z), rtol=0, atol=1e-4)
    assert_close(ld + ld_inv, np.zeros(2), rtol=0, atol=1e-4)
    want = -2 * 16 * np.log(1 / (1 + np.exp(-2.0)))
    assert_close(ld, np.full(2, want), rtol=1e-5, atol=1e-4)


def test_jax_image_convs_raise_in_float64_r15():
    """R15: JAX's ``_conv`` asks for float32 results, which JAX refuses for
    float64 inputs; the port keeps the input's dtype."""
    jn, tn = jflows.ConvNet2d((2, 4, 2)), tflows.ConvNet2d((2, 4, 2))
    tree = random_tree(shapes(jn), 24)
    x = np.random.default_rng(25).normal(size=(2, 2, 4, 4))
    with jax.enable_x64(True), pytest.raises(TypeError,
                                             match="preferred_element_type"):
        jn.apply(to_jax(tree), jnp.asarray(x))
    assert tn.apply(to_torch(tree, F64_T), torch.as_tensor(x)).dtype == F64_T


@pytest.mark.parametrize("stride,padding,x_grad",
                         [(1, 1, True), (2, 1, True), (1, 0, True),
                          (1, 1, False)])
def test_conv2d_passes_gradcheck_and_gradgradcheck(stride, padding, x_grad):
    """``nets.conv2d``'s hand-wired backward and double backward (the
    only path of every conv in the port) against finite differences in
    float64, with and without the input's gradient."""
    from flowstate_tpu_torch.flows.nets import conv2d

    rng = np.random.default_rng(26)
    x = torch.as_tensor(rng.normal(size=(2, 3, 5, 5))).requires_grad_(x_grad)
    w = torch.as_tensor(rng.normal(size=(4, 3, 3, 3))).requires_grad_()

    def f(x, w):
        return conv2d(x, w, stride=stride, padding=padding)

    assert torch.autograd.gradcheck(f, (x, w))
    assert torch.autograd.gradgradcheck(f, (x, w))
    ref = torch.nn.functional.conv2d(x, w, stride=stride, padding=padding)
    assert_close(f(x, w).detach(), np_(ref.detach()))


# ----- GlowBase and MultiscaleFlow ----------------------------------------

def test_glow_base_matches_jax():
    shape = (3, 4, 4)
    jb, tb = jflows.GlowBase(shape), tflows.GlowBase(shape)
    rng = np.random.default_rng(30)
    params = {"loc": rng.normal(0, 0.2, 3), "log_scale_raw":
              rng.normal(0, 0.2, 3)}
    z = rng.normal(size=(5, *shape))
    tp = to_torch(params, F64_T)
    with jax.enable_x64(True):
        for kw in (dict(), dict(params=to_jax(params)),
                   dict(params=to_jax(params), temperature=0.7)):
            want = jb.log_prob(jnp.asarray(z), **kw)
            got = tb.log_prob(torch.as_tensor(z), **(
                {**kw, "params": tp} if "params" in kw else kw))
            assert_close(got, want)
    g = torch.Generator().manual_seed(31)
    s = tb.sample(20000, g, "cpu", params=to_torch(params, torch.float32),
                  temperature=0.5)
    assert s.shape == (20000, *shape) and s.dtype == torch.float32
    loc = 3.0 * params["loc"]
    std = 0.5 * np.exp(3.0 * params["log_scale_raw"])
    mean = np_(s.mean(dim=(0, 2, 3)))
    assert np.all(np.abs(mean - loc) < 5 * std / np.sqrt(20000 * 16))
    np.testing.assert_allclose(np_(s.std(dim=(0, 2, 3))), std, rtol=0.02)


def glow_multiscale(m, levels=2, k=2, hidden=8, channels=3, size=8,
                    place=None):
    """The normflows Glow example's architecture from a flows package:
    level i has K ``GlowBlock(3 * 2^(L + 1 - i))`` and a ``Squeeze``,
    levels joined by channel ``Merge``s.  With ``place`` (the port), each
    layer is held in a ``ParamLayer`` made by ``place``."""
    flows, bases, merges = [], [], []
    for i in range(levels):
        level = [m.GlowBlock(channels * 2 ** (levels + 1 - i), hidden)
                 for _ in range(k)] + [m.Squeeze()]
        flows.append(tuple(level) if place is None
                     else [place(layer) for layer in level])
        if i > 0:
            merges.append(m.Merge(mode="channel"))
            c = channels * 2 ** (levels - i)
            s = size // 2 ** (levels - i)
        else:
            c = channels * 2 ** (levels + 1)
            s = size // 2 ** levels
        bases.append(m.GlowBase((c, s, s)))
    if place is None:
        return m.MultiscaleFlow(tuple(bases), tuple(flows), tuple(merges))
    return MultiscaleFlow(bases, flows, merges, device="cpu")


def multiscale_pair(seed, scale=0.1):
    jm = glow_multiscale(jflows)
    tm = glow_multiscale(tflows, place=lambda layer: ParamLayer(
        layer, device="cpu")).double()
    tree = random_tree(shapes(jm), seed, scale)
    for level in tree["flows"]:
        for layer in level:
            if layer:
                c = layer["conv1x1"]
                c["sign_upper_diag"] = np.sign(c["sign_upper_diag"])
    params_from_jax(tree, tm)
    return jm, tm, tree


def images(seed, n=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 3, 8, 8)) + rng.uniform(
        size=(n, 3, 8, 8))) / 256.0


def test_multiscale_flow_matches_jax():
    """log q, the latents and the log-det of a Glow ``MultiscaleFlow``
    (L = 2, K = 2, hidden 8, 3 x 8 x 8) against JAX's on the carried
    tree; the tree back out equal; the port's round trip (the blocks'
    forward is held against JAX's in ``test_glow_block_matches_jax``);
    samples."""
    jm, tm, tree = multiscale_pair(32)
    x = images(33)
    back = params_to_jax(tm)
    assert set(back) == {"flows", "transform"} and back["transform"] is None
    assert [len(level) for level in back["flows"]] == [3, 3]
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with jax.enable_x64(True):
        j_z, j_ld = jax.jit(jm.inverse_and_log_det)(to_jax(tree),
                                                    jnp.asarray(x))
        j_lp = j_ld + sum(b.log_prob(z) for b, z in zip(jm.bases, j_z))
    tx = torch.as_tensor(x)
    with torch.no_grad():
        assert_close(tm.log_prob(tx), j_lp)
        z_list, ld = tm.inverse_and_log_det(tx)
        assert [tuple(z.shape[1:]) for z in z_list] == [(24, 2, 2),
                                                        (6, 4, 4)]
        for a, b in zip(z_list, j_z):
            assert_close(a, b)
        assert_close(ld, j_ld)
        x_back, ld_f = tm.forward_and_log_det(z_list)
        assert_close(x_back, x, **ROUND_TRIP)
        assert_close(ld + ld_f, np.zeros(len(x)), **ROUND_TRIP)
        s = tm.sample(6, torch.Generator().manual_seed(34))
    assert s.shape == (6, 3, 8, 8) and s.dtype == F64_T
    assert torch.isfinite(s).all()


def test_multiscale_flow_adam_step_matches_jax():
    """One Adam step of the Glow ``MultiscaleFlow``'s ``forward_kld`` (the
    port's ``train`` step against JAX's, ``TOL``); the bases stay out of
    ``parameters()``."""
    jm, tm, tree = multiscale_pair(35, 0.2)
    x = images(36, 16)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(list(tm.parameters())) == n_leaves
    with jax.enable_x64(True):
        step, state = jax_stepper(jm, to_jax(tree))
        state, jloss = step(state, jnp.asarray(x))
    tstep, opt_state = port_stepper(tm)
    opt_state, loss = tstep(opt_state, torch.as_tensor(x))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert_params_equal(tm, state.params)


def test_multiscale_flow_with_a_transform_and_class_labels():
    """A ``Logit``-style data transform's tree rides in ``transform``, and
    ``y`` reaches the bases: log q against JAX's."""
    def build(m, place=None):
        bases = (m.ClassCondDiagGaussian(2, 3), m.ClassCondDiagGaussian(2, 3))
        flows = ((m.AffineConstFlow(2),), (m.AffineConstFlow(4),))
        transform = m.AffineConstFlow(4)
        if place is None:
            return m.MultiscaleFlow(bases, flows, (m.Merge(),), transform)
        return MultiscaleFlow(bases, [[place(f) for f in level]
                                      for level in flows], (m.Merge(),),
                              place(transform), device="cpu")

    jm = build(jflows)
    tm = build(tflows, lambda f: ParamLayer(f, device="cpu")).double()
    tree = random_tree(shapes(jm), 37)
    params_from_jax(tree, tm)
    x = np.random.default_rng(38).normal(size=(6, 4))
    y = np.eye(3)[np.arange(6) % 3]
    with jax.enable_x64(True):
        want = jax.jit(jm.log_prob)(to_jax(tree), jnp.asarray(x),
                                    jnp.asarray(y))
    assert_close(tm.log_prob(torch.as_tensor(x), torch.as_tensor(y)), want)
    s = tm.sample(6, torch.Generator().manual_seed(39),
                  torch.as_tensor(y, dtype=torch.float32))
    assert s.shape == (6, 4)


# ----- a residual flow's Adam step ----------------------------------------

def residual_flow(m, place=None):
    """A ``Residual(LipschitzMLP)`` block (the exact log-det) and an
    ``InducedNormMLP`` block, each followed by ``ActNorm``, over a
    ``DiagGaussian``."""
    layers = []
    for net in (m.LipschitzMLP((2, 16, 16, 2), coeff=0.9),
                m.InducedNormMLP((2, 16, 2), coeff=0.9)):
        layers += [m.Residual(net, estimator="exact", dim=2), m.ActNorm(2)]
    if place is None:
        return m.NormalizingFlow(m.DiagGaussian(2), tuple(layers))
    return NormalizingFlow(m.DiagGaussian(2), [place(l) for l in layers],
                           device="cpu")


def test_residual_flow_adam_step_matches_jax():
    """log q, its gradient and one Adam step against JAX's: the
    ``LipschitzMLP`` nets' ``u`` take a gradient, the ``InducedNormMLP``'s
    ``u`` and ``v`` a zero one (``GRAD``), in both packages; the step
    within ``TOL``.  (The training step's coupled weight decay still moves
    a leaf with a zero gradient, by the learning rate times its sign, in
    both packages alike.)"""
    jm = residual_flow(jflows)
    tm = residual_flow(tflows, lambda l: ParamLayer(l, device="cpu")).double()
    with jax.enable_x64(True):
        tree = jax64(jm.init_params(jax.random.key(41)))
    params_from_jax(tree, tm)
    x = 2.0 * np.random.default_rng(42).normal(size=(16, 2))
    with jax.enable_x64(True):
        assert_close(tm.log_prob(torch.as_tensor(x)).detach(),
                     jax.jit(jm.log_prob)(to_jax(tree), jnp.asarray(x)))
        j_grads = jax.jit(jax.grad(jm.forward_kld))(to_jax(tree),
                                                    jnp.asarray(x))
        step, state = jax_stepper(jm, to_jax(tree))
        state, jloss = step(state, jnp.asarray(x))
    params = list(tm.parameters())
    grads = torch.autograd.grad(tm.forward_kld(torch.as_tensor(x)), params,
                                allow_unused=True, materialize_grads=True)
    by_leaf = dict(zip(map(id, params), grads))
    t_grads = tuple(tree_map(lambda p: np_(by_leaf[id(p)]),
                             layer.params.tree()) for layer in tm.layers)
    for a, b in zip(jax.tree_util.tree_leaves(t_grads),
                    jax.tree_util.tree_leaves(j_grads)):
        assert_close(a, b, **GRAD)
    # where the normalisation binds, u has a gradient
    assert any(np.any(g["u"] != 0) for g in t_grads[0]["net"])
    for g_t, g_j in zip(t_grads[2]["net"], j_grads[2]["net"]):
        for k in ("u", "v"):
            assert not np.any(g_t[k]) and not np.any(np.asarray(g_j[k]))
        assert np.any(g_t["w"] != 0)
    tstep, opt_state = port_stepper(tm)
    opt_state, loss = tstep(opt_state, torch.as_tensor(x))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert_params_equal(tm, state.params)
