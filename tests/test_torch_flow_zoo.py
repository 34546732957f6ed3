"""The port's dense flow zoo (``flowstate_tpu_torch.flows``: the affine,
autoregressive, mixing, elementary, normalization, periodic, reshape and
transform layers, ``Reverse`` / ``Composite``, ``flows.utils`` and the
bases) against the JAX package's, on the same seeded weights and inputs.

Weights are a seeded numpy tree shaped like the JAX layer's own init,
handed to JAX inside ``jax.enable_x64`` and to the port as float64
tensors (or carried by ``params_from_jax`` into a ``ParamLayer``).  Every
layer is built from the same constructor call in both packages (the
names and signatures match).  Tolerances:

* float64 on both sides, the same arithmetic: 1e-10 (``F64``);
* JAX's MADE takes its products with ``preferred_element_type=float32``
  even under x64 (``flows/autoregressive.py:89-90``, ROADMAP R14).  The
  fixture ``jax_made_in_float64`` drops that argument from ``jnp.dot``
  while JAX runs, so JAX's MADE is float64 throughout and the port is
  held to it at ``F64``; ``test_made_float32_products_are_r14`` runs JAX
  as it is and bounds the difference by ``R14``;
* the port's own round trips (forward then inverse) in float64: 1e-8,
  and its log-dets against ``slogdet`` of the autograd Jacobian: 1e-8;
* sampling checks on the port alone, at 4096 or 20,000 draws: a few
  standard errors, stated beside each.

Sizes are small: 6 features, hidden 16, batches of 16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowstate_tpu.flows as jflows
from flowstate_tpu.flows import autoregressive as jautoregressive
from flowstate_tpu.flows import utils as jutils
import flowstate_tpu_torch.flows as tflows
from flowstate_tpu_torch.flows import (
    NormalizingFlow, ParamLayer, params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.flows import utils as tutils

from test_torch_flow import F64, np_, random_tree, to_jax, to_torch
from test_torch_training import (
    TOL, assert_params_equal, jax_stepper, port_stepper,
)

torch.set_num_threads(1)

D, B, HIDDEN = 6, 16, 16
ROUND_TRIP = dict(rtol=1e-8, atol=1e-8)
# JAX's MADE as it is (float32 products) against the port's float64, of
# (1 + max |JAX|): float32's 6e-8 rounding, grown through three layers
# and the spline
R14 = 1e-5
F64_T = torch.float64


@pytest.fixture(autouse=True)
def jax_made_in_float64(request, monkeypatch):
    """JAX's MADE without its float32 products (R14), except in the test
    that measures them."""
    if request.node.originalname == "test_made_float32_products_are_r14":
        return
    dot = jnp.dot

    def float64_dot(*args, preferred_element_type=None, **kwargs):
        return dot(*args, **kwargs)

    monkeypatch.setattr(jautoregressive.jnp, "dot", float64_dot)


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np_(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), **(tol or F64))


def inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(B, D))
    if kind == "box":                  # inside a spline's interval of 3
        return rng.uniform(-2.5, 2.5, size=(B, D))
    if kind == "unit":                 # the logit transform's data
        return rng.uniform(0.05, 0.95, size=(B, D))
    if kind == "odd":
        return rng.normal(size=(B, 5))
    if kind == "image":
        return rng.normal(size=(2, 4, 4, 4))
    raise ValueError(kind)


def mlp(m, *widths):
    return m.MLP(tuple(widths))


# name -> (the layer from a flows package, input kind, directions)
BOTH = ("forward", "inverse")
LAYERS = {
    "affine_const": (lambda m: m.AffineConstFlow(D), "normal", BOTH),
    "affine_const_shift_only": (lambda m: m.AffineConstFlow(D, scale=False),
                                "normal", BOTH),
    "coupling_block_exp": (lambda m: m.AffineCouplingBlock(
        mlp(m, D // 2, HIDDEN, D)), "normal", BOTH),
    "coupling_block_sigmoid": (lambda m: m.AffineCouplingBlock(
        mlp(m, D // 2, HIDDEN, D), scale_map="sigmoid"), "normal", BOTH),
    "coupling_block_sigmoid_inv": (lambda m: m.AffineCouplingBlock(
        mlp(m, D // 2, HIDDEN, D), scale_map="sigmoid_inv"), "normal", BOTH),
    "coupling_block_shift": (lambda m: m.AffineCouplingBlock(
        mlp(m, D // 2, HIDDEN, D // 2), scale=False), "normal", BOTH),
    "masked_affine": (lambda m: m.MaskedAffineFlow(
        (1, 0) * 3, mlp(m, D, HIDDEN, D), mlp(m, D, HIDDEN, D)),
        "normal", BOTH),
    "masked_affine_nice": (lambda m: m.MaskedAffineFlow(
        (0, 1) * 3, None, mlp(m, D, HIDDEN, D)), "normal", BOTH),
    "permute_shuffle": (lambda m: m.Permute(D, seed=3), "normal", BOTH),
    "permute_swap": (lambda m: m.Permute(D, mode="swap"), "normal", BOTH),
    "permute_swap_odd": (lambda m: m.Permute(5, mode="swap"), "odd", BOTH),
    "invertible_affine_lu": (lambda m: m.InvertibleAffine(D, seed=2),
                             "normal", BOTH),
    "invertible_affine_dense": (lambda m: m.InvertibleAffine(
        D, use_lu=False), "normal", BOTH),
    "lu_linear_permute": (lambda m: m.LULinearPermute(D, seed=4), "normal",
                          BOTH),
    "invertible_1x1_conv": (lambda m: m.Invertible1x1Conv(4), "image",
                            BOTH),
    "planar_tanh": (lambda m: m.Planar(D), "normal", ("forward",)),
    "planar_leaky_relu": (lambda m: m.Planar(D, act="leaky_relu"), "normal",
                          BOTH),
    "radial": (lambda m: m.Radial(D), "normal", ("forward",)),
    "actnorm": (lambda m: m.ActNorm(D), "normal", BOTH),
    "batchnorm": (lambda m: m.BatchNorm(), "normal", ("forward",)),
    "periodic_wrap": (lambda m: m.PeriodicWrap((0, 2, 5), bound=0.7),
                      "normal", BOTH),
    "periodic_shift": (lambda m: m.PeriodicShift((1, 3), bound=0.9,
                                                 shift=0.4), "normal", BOTH),
    "squeeze": (lambda m: m.Squeeze(), "image", BOTH),
    "logit_transform": (lambda m: m.LogitTransform(0.05), "unit",
                        ("inverse",)),
    "logit_transform_forward": (lambda m: m.LogitTransform(0.05), "normal",
                                ("forward",)),
    "shift": (lambda m: m.Shift(0.3), "normal", BOTH),
    "reverse": (lambda m: m.Reverse(m.AffineCouplingBlock(
        mlp(m, D // 2, HIDDEN, D))), "normal", BOTH),
    "composite": (lambda m: m.Composite((
        m.AffineConstFlow(D), m.Permute(D, seed=1),
        m.AffineCouplingBlock(mlp(m, D // 2, HIDDEN, D)))), "normal", BOTH),
    "masked_affine_autoregressive": (lambda m: m.MaskedAffineAutoregressive(
        D, HIDDEN), "normal", BOTH),
    "rqs_autoregressive_interval": (
        lambda m: m.MaskedPiecewiseRQSAutoregressive(
            D, HIDDEN, num_bins=5, tails=None, tail_bound=3.0), "box", BOTH),
    "rqs_autoregressive_linear": (
        lambda m: m.MaskedPiecewiseRQSAutoregressive(
            D, HIDDEN, num_bins=5, tails="linear", tail_bound=2.0),
        "normal", BOTH),
    "rqs_autoregressive_circular": (
        lambda m: m.MaskedPiecewiseRQSAutoregressive(
            D, HIDDEN, num_bins=5, tails="circular", tail_bound=3.0),
        "box", BOTH),
    "rqs_autoregressive_per_dim": (
        lambda m: m.MaskedPiecewiseRQSAutoregressive(
            D, HIDDEN, num_bins=5, tails=("circular", "linear") * 3,
            tail_bound=3.0), "box", BOTH),
    "autoregressive_rqs": (lambda m: m.AutoregressiveRationalQuadraticSpline(
        D, 2, HIDDEN, num_bins=4, tail_bound=2.0), "normal", BOTH),
    "circular_autoregressive_rqs": (
        lambda m: m.CircularAutoregressiveRationalQuadraticSpline(
            D, 2, HIDDEN, ind_circ=(0, 2, 4), num_bins=4, tail_bound=3.0),
        "box", BOTH),
}


def layer_pair(name, seed, scale=0.3):
    """(JAX layer, port layer, numpy tree, input) of ``name``."""
    make, kind, _ = LAYERS[name]
    jl, tl = make(jflows), make(tflows)
    tree = random_tree(jl.init_params(jax.random.key(0)), seed, scale)
    return jl, tl, tree, inputs(kind, seed + 100)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    """Each direction's output and log-det against JAX's in float64, and
    the port's own round trip where the layer has both."""
    directions = LAYERS[name][2]
    jl, tl, tree, z = layer_pair(name, 7)
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        for direction in directions:
            j_out, j_ld = getattr(jl, direction)(to_jax(tree), jnp.asarray(z))
            t_out, t_ld = getattr(tl, direction)(tp, torch.as_tensor(z))
            assert t_out.dtype == F64_T and t_ld.dtype == F64_T
            assert_close(t_out, j_out)
            assert_close(t_ld, j_ld)
    if directions == BOTH and not name.startswith("periodic"):
        zt = torch.as_tensor(z)
        y, ld = tl.forward(tp, zt)
        back, ld_inv = tl.inverse(tp, y)
        assert_close(back, z, **ROUND_TRIP)
        assert_close(ld + ld_inv, np.zeros(len(z)), **ROUND_TRIP)


@pytest.mark.parametrize("name", ["planar_tanh", "planar_leaky_relu",
                                  "radial", "invertible_affine_lu",
                                  "invertible_affine_dense",
                                  "masked_affine_autoregressive",
                                  "circular_autoregressive_rqs"])
def test_log_det_is_the_jacobians(name):
    """The port's forward log-det against ``slogdet`` of its autograd
    Jacobian at one point (``tests/test_flow_zoo.py``'s check)."""
    _, tl, tree, z = layer_pair(name, 11)
    if name == "invertible_affine_lu":  # the diagonal's signs are +-1
        tree["sign_upper_diag"] = np.sign(tree["sign_upper_diag"])
    tp = to_torch(tree, F64_T)
    x = torch.as_tensor(z[0])
    jac = torch.autograd.functional.jacobian(
        lambda v: tl.forward(tp, v[None])[0][0], x)
    _, ld = tl.forward(tp, x[None])
    _, exact = torch.linalg.slogdet(jac)
    assert_close(ld[0], exact.numpy(), **ROUND_TRIP)


def test_cc_affine_const_matches_jax():
    jl, tl = jflows.CCAffineConst(D, 3), tflows.CCAffineConst(D, 3)
    tree = random_tree(jl.init_params(jax.random.key(0)), 12)
    z = inputs("normal", 13)
    y = np.eye(3)[np.arange(B) % 3]
    with jax.enable_x64(True):
        for direction in BOTH:
            j = getattr(jl, direction)(to_jax(tree), jnp.asarray(z),
                                       jnp.asarray(y))
            t = getattr(tl, direction)(to_torch(tree, F64_T),
                                       torch.as_tensor(z), torch.as_tensor(y))
            for a, b in zip(t, j):
                assert_close(a, b)


@pytest.mark.parametrize("mode", ["channel", "channel_inv", "checkerboard",
                                  "checkerboard_inv"])
def test_split_and_merge_match_jax(mode):
    z = inputs("normal", 14)
    with jax.enable_x64(True):
        (j1, j2), _ = jflows.Split(mode).forward({}, jnp.asarray(z))
        j_merged, _ = jflows.Merge(mode).forward({}, [j1, j2])
    (t1, t2), ld = tflows.Split(mode).forward({}, torch.as_tensor(z))
    np.testing.assert_array_equal(np_(t1), np.asarray(j1))
    np.testing.assert_array_equal(np_(t2), np.asarray(j2))
    assert ld.shape == (B,)
    back, _ = tflows.Split(mode).inverse({}, [t1, t2])
    np.testing.assert_array_equal(np_(back), z)
    merged, _ = tflows.Merge(mode).forward({}, [t1, t2])
    np.testing.assert_array_equal(np_(merged), np.asarray(j_merged))
    (m1, m2), _ = tflows.Merge(mode).inverse({}, merged)
    np.testing.assert_array_equal(np_(m1), np_(t1))


def test_actnorm_data_init_matches_jax_and_whitens():
    """``init_params_from_data`` with ddof 0 (``jnp.std``), as JAX."""
    rng = np.random.default_rng(15)
    z = 3.0 + 2.0 * rng.normal(size=(256, D))
    with jax.enable_x64(True):
        j = jflows.ActNorm(D).init_params_from_data(jnp.asarray(z))
    layer = tflows.ActNorm(D)
    t = layer.init_params_from_data(torch.as_tensor(z))
    for k in ("s", "t"):
        assert_close(t[k], j[k])
    y, _ = layer.forward(t, torch.as_tensor(z))
    assert_close(y.mean(0), np.zeros(D), rtol=0, atol=1e-12)
    assert_close(y.std(0, correction=0), np.ones(D), rtol=0, atol=1e-5)


def test_batchnorm_has_no_inverse():
    z = torch.as_tensor(inputs("normal", 16))
    y, ld = tflows.BatchNorm().forward({}, z)
    assert ld.shape == (B,)
    assert_close(y.mean(0), np.zeros(D), rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError):
        tflows.BatchNorm().inverse({}, y)


def test_periodic_wrap_is_floored_like_jnp_mod():
    """Coordinates below -bound wrap up, as ``jnp.mod`` does (``fmod``
    would leave them below)."""
    z = torch.tensor([[2.5, -3.5, 0.7], [-2.1, 1.0, -6.0]],
                     dtype=torch.float64)
    out, _ = tflows.PeriodicWrap((0, 1, 2), bound=2.0).inverse({}, z)
    assert_close(out, [[-1.5, 0.5, 0.7], [1.9, 1.0, -2.0]], rtol=0,
                 atol=1e-12)
    shift = tflows.PeriodicShift((0,), bound=2.0, shift=1.0)
    y, _ = shift.forward({}, z)
    back, _ = shift.inverse({}, y)
    assert_close(back[:, 0], [-1.5, 1.9], rtol=0, atol=1e-12)


# ----- MADE ------------------------------------------------------------

def made_pair(periodic, multiplier=3, seed=20):
    kw = dict(features=5, hidden_features=HIDDEN, num_blocks=2,
              output_multiplier=multiplier,
              periodic_scale=math.pi / 2 if periodic else None)
    jm, tm = jflows.MADE(**kw), tflows.MADE(**kw)
    tree = random_tree(jm.init_params(jax.random.key(0)), seed, 0.5)
    x = np.random.default_rng(seed + 1).normal(size=(B, 5))
    return jm, tm, tree, x


@pytest.mark.parametrize("periodic", [False, True])
def test_made_matches_jax_and_is_autoregressive(periodic):
    jm, tm, tree, x = made_pair(periodic)
    for a, b in zip(tm._masks(), jm._masks()):
        np.testing.assert_array_equal(a, b)
    with jax.enable_x64(True):
        j = jm.apply(to_jax(tree), jnp.asarray(x))
    tp = to_torch(tree, F64_T)
    assert_close(tm.apply(tp, torch.as_tensor(x)), j)
    # output unit i * M + k depends on no input >= i
    jac = torch.autograd.functional.jacobian(
        lambda v: tm.apply(tp, v[None])[0], torch.as_tensor(x[0]))
    jac = np_(jac).reshape(5, 3, 5)
    for i in range(5):
        assert np.all(jac[i, :, i:] == 0.0), i


def test_made_float32_products_are_r14(capsys):
    """JAX's MADE as it is takes float32 products under x64: bounded by
    ``R14`` against the port's float64, and not float64-exact."""
    jm, tm, tree, x = made_pair(True, multiplier=16, seed=22)
    with jax.enable_x64(True):
        j = np.asarray(jm.apply(to_jax(tree), jnp.asarray(x)))
    t = np_(tm.apply(to_torch(tree, F64_T), torch.as_tensor(x)))
    err = np.max(np.abs(t - j)) / (1.0 + np.max(np.abs(j)))
    with capsys.disabled():
        print(f"\nR14: JAX's MADE (float32 products) vs the port's float64: "
              f"{err:.3g} of (1 + max |JAX|)")
    assert 1e-12 < err <= R14


def test_made_identity_init_gives_the_identity_spline():
    layer = tflows.AutoregressiveRationalQuadraticSpline(D, 2, HIDDEN,
                                                         num_bins=4)
    params = layer.init_params(torch.Generator().manual_seed(0),
                               dtype=F64_T, device="cpu")
    z = torch.as_tensor(inputs("normal", 23))
    for direction in BOTH:
        y, ld = getattr(layer, direction)(params, z)
        assert_close(y, np_(z), rtol=0, atol=1e-9)
        assert_close(ld, np.zeros(B), rtol=0, atol=1e-9)


# ----- flows.utils -----------------------------------------------------

def test_geometry_and_preprocessing_match_jax():
    rng = np.random.default_rng(24)
    x = rng.normal(size=(8, 4 * 2))
    conf = x.reshape(8, 4, 2)
    rij = conf[:, :, None, :] - conf[:, None, :, :]
    with jax.enable_x64(True):
        jx = jnp.asarray(x)
        want = [jutils.compute_distances(jx, 4, 2),
                jutils.compute_distances(jx, 4, 2, remove_duplicates=False),
                jutils.distances_from_vectors(jnp.asarray(rij)),
                jutils.remove_mean(jx, 4, 2),
                jutils.Logit(0.1)(jnp.asarray(np.abs(x) / 4.0)),
                jutils.Logit(0.1).inverse(jx), jutils.Scale(0.5)(jx)]
    tx = torch.as_tensor(x)
    got = [tutils.compute_distances(tx, 4, 2),
           tutils.compute_distances(tx, 4, 2, remove_duplicates=False),
           tutils.distances_from_vectors(torch.as_tensor(rij)),
           tutils.remove_mean(tx, 4, 2),
           tutils.Logit(0.1)(torch.as_tensor(np.abs(x) / 4.0)),
           tutils.Logit(0.1).inverse(tx), tutils.Scale(0.5)(tx)]
    for a, b in zip(got, want):
        assert_close(a, b)
    jit = tutils.Jitter(0.25)(tx, torch.Generator().manual_seed(1))
    assert torch.all((jit - tx >= 0.0) & (jit - tx < 0.25))


def zoo_flows(seed):
    """JAX's and the port's ``NormalizingFlow`` of an ``AffineConstFlow``,
    a swap and a coupling block over ``DiagGaussian(D)``, and the numpy
    tree of both."""
    def layers(m):
        return (m.AffineConstFlow(D), m.Permute(D, mode="swap"),
                m.AffineCouplingBlock(mlp(m, D // 2, HIDDEN, D)))

    jm = jflows.NormalizingFlow(jflows.DiagGaussian(D), layers(jflows))
    tree = random_tree(jm.init_params(jax.random.key(0)), seed, 0.3)
    tm = NormalizingFlow(tflows.DiagGaussian(D),
                         [ParamLayer(l, device="cpu") for l in
                          layers(tflows)], device="cpu").to(F64_T)
    return jm, params_from_jax(tree, tm), tree


def test_bits_per_dim_matches_jax():
    jm, tm, tree = zoo_flows(25)
    x = inputs("normal", 26)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        want = jutils.bits_per_dim(jm, jp, jnp.asarray(x))
        want_ds = jutils.bits_per_dim_dataset(
            jm, jp, [jnp.asarray(x[:8]), jnp.asarray(x[8:])])
    with torch.no_grad():
        assert_close(tutils.bits_per_dim(tm, torch.as_tensor(x)), want)
        got_ds = tutils.bits_per_dim_dataset(
            tm, [torch.as_tensor(x[:8]), torch.as_tensor(x[8:])])
    assert_close(got_ds, want_ds)


# ----- the flow over a DiagGaussian, and F11 ---------------------------

def test_flow_over_a_diag_gaussian_matches_jax_and_trains_its_layers_only():
    """log q against JAX's; one Adam step of the port's ``train`` step
    against JAX's (``TOL``, as ``test_torch_training.py``); the base's
    log-density unchanged and outside ``parameters()`` on both sides."""
    jm, tm, tree = zoo_flows(27)
    x = inputs("normal", 28)
    n_layer_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(list(tm.parameters())) == n_layer_leaves
    tx = torch.as_tensor(x)
    with jax.enable_x64(True):
        jp, jx = to_jax(tree), jnp.asarray(x)
        assert_close(tm.log_prob(tx).detach(), jm.log_prob(jp, jx))
        j_base = np.asarray(jm.base.log_prob(jx))
        t_base = tm.base.log_prob(tx)
        assert_close(t_base, j_base)
        step, state = jax_stepper(jm, jp)
        state, jloss = step(state, jx)
        np.testing.assert_array_equal(np.asarray(jm.base.log_prob(jx)),
                                      j_base)
        tstep, opt_state = port_stepper(tm)
        opt_state, loss = tstep(opt_state, tx)
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
        assert_params_equal(tm, state.params)
    assert torch.equal(tm.base.log_prob(tx), t_base)


def test_flow_without_parameters_runs_f11():
    """A flow of parameter-free layers (``Permute``, ``PeriodicWrap``)
    over ``UniformBase``: JAX runs it, and so does the port (F11: its
    ``device`` and ``dtype`` came from the first parameter)."""
    def layers(m):
        return (m.Permute(D, seed=5), m.PeriodicWrap((0, 3), bound=1.0),
                m.Permute(D, mode="swap"))

    jm = jflows.NormalizingFlow(jflows.UniformBase(D, -1.0, 1.0),
                                layers(jflows))
    tm = NormalizingFlow(tflows.UniformBase(D, -1.0, 1.0),
                         [ParamLayer(l, device="cpu") for l in
                          layers(tflows)], device="cpu", dtype=F64_T)
    assert list(tm.parameters()) == [] and params_to_jax(tm) == ({}, {}, {})
    assert tm.device == torch.device("cpu") and tm.dtype == F64_T
    x = np.random.default_rng(29).uniform(-1.5, 1.5, size=(B, D))
    jp = jm.init_params(jax.random.key(0))
    with jax.enable_x64(True):
        j_lp = jm.log_prob(jp, jnp.asarray(x))
        j_z = jm.inverse(jp, jnp.asarray(x))
    assert_close(tm.log_prob(torch.as_tensor(x)), j_lp)
    assert_close(tm.inverse(torch.as_tensor(x)), j_z)
    s, lq = tm.sample_and_log_prob(64, torch.Generator().manual_seed(2))
    assert s.dtype == F64_T and s.shape == (64, D)
    assert torch.all(s.abs() <= 1.0) and torch.all(lq == -D * math.log(2.0))


# ----- the bases -------------------------------------------------------

BASES = {
    "uniform_base": lambda m: m.UniformBase(D, -2.0, 3.0),
    "diag_gaussian": lambda m: m.DiagGaussian(D),
    "uniform_gaussian_fork": lambda m: m.UniformGaussian(
        D, (0, 2, 3), scale=(1.5, 2.0, 0.5, 1.0, 3.0, 0.7)),
    "uniform_gaussian": lambda m: m.UniformGaussian(
        D, (0, 2, 3), scale=(1.5, 2.0, 0.5, 1.0, 3.0, 0.7),
        fork_semantics=False),
    "gaussian_mixture": lambda m: m.GaussianMixture(3, D),
    "affine_gaussian": lambda m: m.AffineGaussian(D),
    "gaussian_pca": lambda m: m.GaussianPCA(D, 2, sigma=0.3),
}
TRAINABLE = ("diag_gaussian", "gaussian_mixture", "affine_gaussian",
             "gaussian_pca")


@pytest.mark.parametrize("name", sorted(BASES))
def test_base_log_prob_matches_jax(name):
    jb, tb = BASES[name](jflows), BASES[name](tflows)
    z = 1.5 * inputs("normal", 30)
    with jax.enable_x64(True):
        if name in TRAINABLE:
            shapes = params_to_jax(ParamLayer(tb, device="cpu"))
            tree = random_tree(shapes, 31, 0.3)
            j = jb.log_prob(jnp.asarray(z), to_jax(tree))
            t = tb.log_prob(torch.as_tensor(z), to_torch(tree, F64_T))
        else:
            j = jb.log_prob(jnp.asarray(z))
            t = tb.log_prob(torch.as_tensor(z))
    assert t.dtype == F64_T
    assert_close(t, j)
    if name == "uniform_base":
        assert np.isneginf(np_(t)).any() and np.isfinite(np_(t)).any()


def test_class_cond_diag_gaussian_matches_jax():
    jb, tb = jflows.ClassCondDiagGaussian(D, 3), \
        tflows.ClassCondDiagGaussian(D, 3)
    tree = random_tree(jb.init_params(), 32, 0.3)
    z = inputs("normal", 33)
    y = np.eye(3)[np.arange(B) % 3]
    with jax.enable_x64(True):
        for temp in (None, 0.7):
            j = jb.log_prob(jnp.asarray(z), jnp.asarray(y), to_jax(tree),
                            temperature=temp)
            t = tb.log_prob(torch.as_tensor(z), torch.as_tensor(y),
                            to_torch(tree, F64_T), temperature=temp)
            assert_close(t, j)


def test_bases_sample_their_distributions():
    """The port's draws at 20,000 points: moments within 5 standard
    errors (0.035 for a unit deviation), the supports exact."""
    g = torch.Generator().manual_seed(34)
    n, tol = 20_000, 5 / math.sqrt(20_000)
    dev = "cpu"
    s = tflows.UniformBase(D, -2.0, 3.0).sample(n, g, dev)
    assert s.dtype == torch.float32 and s.shape == (n, D)
    assert torch.all((s >= -2.0) & (s <= 3.0))
    params = {"loc": torch.linspace(-1, 1, D), "log_scale":
              torch.linspace(-0.5, 0.5, D)}
    s = tflows.DiagGaussian(D).sample(n, g, dev, params)
    assert torch.allclose(s.mean(0), params["loc"], atol=tol * 1.7)
    assert torch.allclose(s.std(0), params["log_scale"].exp(),
                          rtol=3 * tol)
    assert torch.allclose(tflows.DiagGaussian(D).sample(n, g, dev).std(0),
                          torch.ones(D), rtol=3 * tol)
    scale = (1.5, 2.0, 0.5, 1.0, 3.0, 0.7)
    fork = tflows.UniformGaussian(D, (0, 2, 3), scale).sample(n, g, dev)
    assert torch.all(fork.abs() <= 0.5 * torch.tensor(scale))
    proper = tflows.UniformGaussian(D, (0, 2, 3), scale,
                                    fork_semantics=False).sample(n, g, dev)
    assert torch.allclose(proper[:, [1, 4, 5]].std(0),
                          torch.tensor([2.0, 3.0, 0.7]), rtol=3 * tol)
    mix = tflows.GaussianMixture(3, D)
    mp = mix.init_params(g, device=dev)
    mp["loc"] = 10.0 * torch.arange(3.0)[:, None].expand(3, D)
    mp["weight_logits"] = torch.tensor([0.0, math.log(3.0), -50.0])
    s = mix.sample(n, g, dev, mp)
    near = torch.cdist(s, mp["loc"]).argmin(1)
    frac = torch.bincount(near, minlength=3) / n
    assert abs(float(frac[1]) - 0.75) < 0.02 and float(frac[2]) == 0.0
    assert torch.isfinite(mix.log_prob(s, mp)).all()
    y = torch.eye(3)[torch.arange(n) % 3]
    cc = tflows.ClassCondDiagGaussian(D, 3)
    cp = {"loc": torch.arange(3.0)[:, None].expand(3, D).clone(),
          "log_scale": torch.zeros(3, D)}
    s = cc.sample(n, y, g, cp, temperature=0.5)
    assert torch.allclose(s[::3].mean(0), torch.zeros(D), atol=tol)
    assert torch.allclose(s[2::3].std(0), torch.full((D,), 0.5),
                          rtol=3 * tol)
    pca = tflows.GaussianPCA(D, 2)
    pp = pca.init_params(g, device=dev)
    s = pca.sample(n, g, dev, pp)
    assert torch.allclose(torch.cov(s.T), pp["W"].T @ pp["W"], atol=0.01)
    s = tflows.AffineGaussian(D).sample(n, g, dev,
                                        {"s": torch.full((D,), 0.5)})
    assert torch.allclose(s.std(0), torch.full((D,), math.exp(0.5)),
                          rtol=3 * tol)


def test_zoo_trees_carry_both_ways():
    """``params_from_jax`` / ``params_to_jax`` on a flow of zoo layers
    (a ``None`` subtree, a list-rooted tree, empty trees) and on a
    ``ParamLayer`` holding a base's tree."""
    def layers(m):
        return (m.MaskedAffineFlow((1, 0) * 3, None, mlp(m, D, HIDDEN, D)),
                m.Composite((m.Permute(D), m.AffineConstFlow(D))),
                m.MaskedAffineAutoregressive(D, HIDDEN))

    jm = jflows.NormalizingFlow(jflows.DiagGaussian(D), layers(jflows))
    tree = random_tree(jm.init_params(jax.random.key(1)), 35)
    tm = NormalizingFlow(tflows.DiagGaussian(D),
                         [ParamLayer(l, device="cpu") for l in
                          layers(tflows)], device="cpu").to(F64_T)
    params_from_jax(tree, tm)
    back = params_to_jax(tm)
    assert back[0]["s"] is None and back[1][0] == {}
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    x = inputs("normal", 36)
    with jax.enable_x64(True):
        assert_close(tm.log_prob(torch.as_tensor(x)).detach(),
                     jm.log_prob(to_jax(tree), jnp.asarray(x)))
    base = ParamLayer(tflows.DiagGaussian(D), device="cpu").to(F64_T)
    base_tree = {"loc": np.arange(D) * 0.1, "log_scale": -np.arange(D) * 0.2}
    params_from_jax(base_tree, base)
    out = params_to_jax(base)
    np.testing.assert_array_equal(out["loc"], base_tree["loc"])
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({"loc": base_tree["loc"]}, base)
    wrong = list(tree)
    wrong[0] = {"s": tree[2]["made"], "t": tree[0]["t"]}
    with pytest.raises(ValueError):
        params_from_jax(tuple(wrong), tm)
