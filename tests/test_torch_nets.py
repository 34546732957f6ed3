"""The port's conditioner nets (``flowstate_tpu_torch.flows.nets``), the
couplings and flow options that reach them, against the JAX package's.

Inputs and weights are seeded numpy arrays; weights are a numpy tree in
the JAX layout, carried into the port by ``params_from_jax`` (or
``to_torch``) and into JAX inside ``jax.enable_x64``.  Tolerances:

* float64 on both sides: 1e-10 (``F64``), as ``test_torch_flow.py``;
* the transformer: JAX takes its attention scores with
  ``preferred_element_type=float32`` even under x64 (``nets.py:246-250``),
  so its float64 output carries float32 rounding of the scores (ROADMAP
  R10).  The tests here drop that argument from ``jnp.einsum`` while JAX
  runs (the fixture ``jax_scores_in_float64``), so JAX's transformer is
  float64 throughout and the port is held to it at ``F64``;
  ``test_transformer_float32_scores_are_r10`` runs JAX as it is and
  bounds the difference by ``R10``;
* bf16: the port's bf16 net against JAX's bf16 net on the same float32
  weights, ``BF16`` (measured, see ``test_bf16_net_matches_jax``); the MH
  consistency of ``tests/test_bf16.py`` at its 5e-3.

Sizes are small: N = 3 and 4, hidden 16, 2 blocks.
"""

import inspect
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.flows import coupling as jcoupling
from flowstate_tpu.flows import nets as jnets
from flowstate_tpu.flows.core import (
    build_circular_flow as j_build_flow,
    build_conditional_circular_flow as j_build_cond,
)
from flowstate_tpu_torch.experiments import algorithm1, algorithm2
from flowstate_tpu_torch.flows import (
    CircularSplineCoupling, CoupledRationalQuadraticSpline, ParamLayer,
    build_circular_flow, build_conditional_circular_flow,
    create_mid_split_binary_mask, create_random_binary_mask, nets as tnets,
    params_from_jax, params_to_jax, tree_map,
)
from flowstate_tpu_torch.utils.config import algorithm1_config

import test_torch_algorithm2
from test_torch_algorithm1 import a1_config
from test_torch_flow import BINS, BOUND, F64, HIDDEN, np_, random_tree
from test_torch_flow import to_jax, to_torch

torch.set_num_threads(1)

NET_TYPES = ["residual", "transformer", "gnn"]
# the port against JAX's transformer as it is (float32 scores), of
# (1 + max |JAX|): float32's 6e-8 rounding of the scores, grown by the
# softmax, the two blocks and the spline
R10 = 3e-5
BF16 = 0.06    # bf16 net against JAX's bf16 net, of (1 + |JAX|)


@pytest.fixture(autouse=True)
def jax_scores_in_float64(request, monkeypatch):
    """JAX's transformer without its float32 scores (R10), except in the
    test that measures them."""
    if request.node.originalname == "test_transformer_float32_scores_are_r10":
        return
    einsum = jnp.einsum

    def float64_einsum(*args, preferred_element_type=None, **kwargs):
        return einsum(*args, **kwargs)

    monkeypatch.setattr(jnets.jnp, "einsum", float64_einsum)


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **F64)


def stacked(tree):
    """Two nets on a leading axis: the tree and twice the tree."""
    return jax.tree_util.tree_map(lambda a: np.stack([a, 2.0 * a]), tree)


# ----- the nets alone --------------------------------------------------------

def nets(name):
    """(JAX net, port net, input width) of ``name`` at the test widths."""
    if name == "mlp":
        return jnets.MLP((5, HIDDEN, HIDDEN, 7)), \
            tnets.MLP((5, HIDDEN, HIDDEN, 7)), 5
    if name == "transformer":
        kw = dict(in_features=6, out_features=13, embed_dim=HIDDEN,
                  num_heads=4, num_layers=2)
        return jnets.TransformerNet(**kw), tnets.TransformerNet(**kw), 6
    if name == "gnn":
        kw = dict(num_node=4, out_dim=13, feat_dim=2, hidden_dim=HIDDEN,
                  num_layers=2)
        return jnets.TorusEGNN(**kw), tnets.TorusEGNN(**kw), 4
    kw = dict(in_features=6, out_features=13, hidden_features=HIDDEN,
              num_blocks=2, use_norm=False)
    return jnets.ResidualNet(**kw), tnets.ResidualNet(**kw), 6


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ["mlp", "transformer", "gnn",
                                  "residual_without_norm"])
def test_net_matches_jax(name, batched):
    """Each net alone, on one tree and on a leading axis of 2 nets (the
    paired pass's form, JAX's ``vmap``); the port's init has JAX's tree."""
    jnet, tnet, width = nets(name)
    init = jnet.init_params(jax.random.key(1))
    tree = random_tree(init, 3)
    shapes = tree_map(lambda a: tuple(a.shape),
                      tnet.init_params(dtype=torch.float64, device="cpu"))
    assert shapes == tree_map(lambda a: tuple(np.shape(a)), tree)
    rng = np.random.default_rng(4)
    x = rng.uniform(-3.0, 3.0, size=(2, 11, width))
    with jax.enable_x64(True):
        if batched:
            want = jax.vmap(jnet.apply)(to_jax(stacked(tree)),
                                        jnp.asarray(x))
        else:
            want = jnet.apply(to_jax(tree), jnp.asarray(x[0]))
    if batched:
        got = tnet.apply(to_torch(stacked(tree), torch.float64),
                         torch.as_tensor(x))
    else:
        got = tnet.apply(to_torch(tree, torch.float64), torch.as_tensor(x[0]))
    assert_close(np_(got), want)


def test_transformer_float32_scores_are_r10():
    """JAX's transformer as it is: its float32 scores (R10) put it
    within ``R10`` of (1 + max |JAX|) of the port's float64 net, coupling
    and flow, and no nearer than float64 would (the fixture's float64
    scores agree to 1e-10)."""
    jnet, tnet, width = nets("transformer")
    tree = random_tree(jnet.init_params(jax.random.key(1)), 3)
    x = np.random.default_rng(4).uniform(-3.0, 3.0, size=(2, 11, width))
    jl, tl = couplings("transformer", 3)
    ltree = random_tree(jl.init_params(jax.random.key(2)), 13)
    xl = points(23, 3)
    with jax.enable_x64(True):
        pairs = [
            (tnet.apply(to_torch(tree, torch.float64), torch.as_tensor(x[0])),
             jnet.apply(to_jax(tree), jnp.asarray(x[0]))),
            (tnet.apply(to_torch(stacked(tree), torch.float64),
                        torch.as_tensor(x)),
             jax.vmap(jnet.apply)(to_jax(stacked(tree)), jnp.asarray(x))),
            (tl.inverse(to_torch(ltree, torch.float64),
                        torch.as_tensor(xl))[1],
             jl.inverse(to_jax(ltree), jnp.asarray(xl))[1])]
    worst = 0.0
    for got, want in pairs:
        want = np.asarray(want)
        err = np.abs(np_(got) - want).max() / (1.0 + np.abs(want).max())
        assert err <= R10, err
        worst = max(worst, err)
    assert worst > 1e-9     # the float32 rounding shows


def test_small_helpers_match_jax():
    """``ConstScaleLayer``, ``clamp_exp`` / ``ClampExp`` and
    ``PeriodicFeaturesCat`` (with and without untouched dims)."""
    x = np.random.default_rng(5).normal(size=(7, 5)) * 2.0
    t = torch.as_tensor(x)
    with jax.enable_x64(True):
        j = jnp.asarray(x)
        pairs = [
            (jnets.ConstScaleLayer(0.7)(j), tnets.ConstScaleLayer(0.7)(t)),
            (jnets.clamp_exp(j), tnets.clamp_exp(t)),
            (jnets.ClampExp(j), tnets.ClampExp(t)),
            (jnets.PeriodicFeaturesCat(5, (0, 3), 1.3)(j),
             tnets.PeriodicFeaturesCat(5, (0, 3), 1.3)(t)),
            (jnets.PeriodicFeaturesCat(5, tuple(range(5)))(j),
             tnets.PeriodicFeaturesCat(5, tuple(range(5)))(t)),
        ]
    for want, got in pairs:
        np.testing.assert_allclose(np_(got), np.asarray(want), **F64)


# ----- couplings -------------------------------------------------------------

def couplings(net_type, n, **kw):
    kw = dict(features=2 * n, num_blocks=2, hidden_units=HIDDEN,
              ind_circ=tuple(range(2 * n)), num_bins=BINS, tail_bound=BOUND,
              net_type=net_type, **kw)
    return jcoupling.CircularSplineCoupling(**kw), CircularSplineCoupling(**kw)


def points(seed, n, m=23):
    x = np.random.default_rng(seed).uniform(-BOUND, BOUND, size=(m, 2 * n))
    x[3] = 0.0
    return x


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("net_type", NET_TYPES)
def test_coupling_matches_jax(net_type, n):
    jl, tl = couplings(net_type, n)
    tree = random_tree(jl.init_params(jax.random.key(2)), 10 + n)
    x = points(20 + n, n)
    p = to_torch(tree, torch.float64)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        for name in ("forward", "inverse"):
            jy, jld = getattr(jl, name)(jp, jnp.asarray(x))
            ty, tld = getattr(tl, name)(p, torch.as_tensor(x))
            assert_close(np_(ty), jy)
            assert_close(np_(tld), jld)
    # the two directions invert each other
    y, ld = tl.forward(p, torch.as_tensor(x))
    back, ld_back = tl.inverse(p, y)
    np.testing.assert_allclose(np_(back), x, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np_(ld + ld_back), 0.0, rtol=0, atol=1e-9)


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_identity_init_is_the_half_roll(net_type):
    """At the port's own init a coupling only rolls the features by half
    (the flow's forward is the coupling's inverse: roll back first)."""
    _, tl = couplings(net_type, 3)
    p = tl.init_params(torch.Generator().manual_seed(0), dtype=torch.float64,
                       device="cpu")
    x = torch.as_tensor(points(30, 3))
    y, ld = tl.inverse(p, x)
    np.testing.assert_allclose(np_(y), np.roll(np_(x), -3, axis=1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(ld), 0.0, rtol=0, atol=1e-12)
    z, ld = tl.forward(p, x)
    np.testing.assert_allclose(np_(z), np.roll(np_(x), 3, axis=1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_(ld), 0.0, rtol=0, atol=1e-12)
    # without init_identity the net's output layer is nn.Linear's default
    _, raw = couplings(net_type, 3, init_identity=False)
    q = raw.init_params(torch.Generator().manual_seed(0), dtype=torch.float64,
                        device="cpu")
    assert bool(q["net"]["final"]["w"].abs().sum() > 0)


@pytest.mark.parametrize("ind_circ", [(), (0, 3)])
def test_coupled_rational_quadratic_spline_matches_jax(ind_circ):
    """Linear tails (circular only on ``ind_circ``), a residual net
    without LayerNorm or featurisation."""
    kw = dict(features=6, num_blocks=2, hidden_units=HIDDEN,
              ind_circ=ind_circ, num_bins=BINS, tail_bound=BOUND)
    jl = jcoupling.CoupledRationalQuadraticSpline(**kw)
    tl = CoupledRationalQuadraticSpline(**kw)
    tree = random_tree(jl.init_params(jax.random.key(3)), 40)
    x = points(41, 3) * 1.3          # some points in the linear tails
    p = to_torch(tree, torch.float64)
    assert tl.net.preprocessing is None and not tl.net.use_norm
    with jax.enable_x64(True):
        for name in ("forward", "inverse"):
            jy, jld = getattr(jl, name)(to_jax(tree), jnp.asarray(x))
            ty, tld = getattr(tl, name)(p, torch.as_tensor(x))
            np.testing.assert_allclose(np_(ty), np.asarray(jy), **F64)
            np.testing.assert_allclose(np_(tld), np.asarray(jld), **F64)


def test_masks_equal_jax_bit_for_bit():
    for features in range(1, 13):
        np.testing.assert_array_equal(
            create_mid_split_binary_mask(features),
            jcoupling.create_mid_split_binary_mask(features))
        for seed in range(5):
            np.testing.assert_array_equal(
                create_random_binary_mask(features, seed),
                jcoupling.create_random_binary_mask(features, seed))


@pytest.mark.parametrize("net_type", ["residual", "gnn"])
def test_explicit_mask_coupling_matches_jax(net_type):
    mask = tuple(int(v) for v in create_random_binary_mask(8, seed=3))
    jl, tl = couplings(net_type, 4, mask=mask)
    assert list(tl.transform_idx) == list(jl.transform_idx)
    tree = random_tree(jl.init_params(jax.random.key(4)), 50)
    x = points(51, 4)
    with jax.enable_x64(True):
        for name in ("forward", "inverse"):
            jy, jld = getattr(jl, name)(to_jax(tree), jnp.asarray(x))
            ty, tld = getattr(tl, name)(to_torch(tree, torch.float64),
                                        torch.as_tensor(x))
            np.testing.assert_allclose(np_(ty), np.asarray(jy), **F64)
            np.testing.assert_allclose(np_(tld), np.asarray(jld), **F64)


# ----- a K=2 flow per net ----------------------------------------------------

def flows(net_type, n, seed, k=2, **kw):
    """The JAX flow, the port's (float64, on the CPU) and one numpy tree
    for both; call JAX inside ``enable_x64``."""
    jm = j_build_flow(n, 2, BOUND, K=k, hidden_units=HIDDEN, num_bins=BINS,
                      net_type=net_type, **kw)
    tree = random_tree(jm.init_params(jax.random.key(0)), seed)
    tm = build_circular_flow(n, 2, BOUND, K=k, hidden_units=HIDDEN,
                             num_bins=BINS, net_type=net_type, device="cpu",
                             **kw).double()
    params_from_jax(tree, tm)
    return jm, tree, tm


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_flow_log_prob_paired_pass_and_round_trip_match_jax(net_type,
                                                            tmp_path):
    """log q and both directions against JAX; the paired pass against the
    separate passes and against JAX's paired pass; the independence
    move's entry point; the tree back through ``params_to_jax`` and the
    port's file loaded by the JAX flow."""
    n = 4
    jm, tree, tm = flows(net_type, n, 60)
    x, z = points(61, n), points(62, n)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        jlp = jm.log_prob(jp, jnp.asarray(x))
        jy, jld = jm.forward_and_log_det(jp, jnp.asarray(z))
        (jyf, jldf), (jzi, jldi) = jm.layers[0].paired_forward_inverse(
            jp[0], jnp.asarray(z), jnp.asarray(x))
    with torch.no_grad():
        tlp = tm.log_prob(torch.as_tensor(x))
        ty, tld = tm.forward_and_log_det(torch.as_tensor(z))
        (yf, ldf), (zi, ldi) = tm.layers[0].paired_forward_inverse(
            torch.as_tensor(z), torch.as_tensor(x))
        sz, sld = tm.inverse_and_log_det(torch.as_tensor(x))
        g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
        xn, lqn, lqo = tm.sample_and_log_prob_with_old(
            9, torch.as_tensor(x[:9]), g())
        xs, lqs = tm.sample_and_log_prob(9, g())
        lq_old = tm.log_prob(torch.as_tensor(x[:9]))
    for got, want in ((tlp, jlp), (ty, jy), (tld, jld), (yf, jyf),
                      (ldf, jldf), (zi, jzi), (ldi, jldi)):
        assert_close(np_(got), want)
    for got, want in ((yf, ty), (ldf, tld), (zi, sz), (ldi, sld), (xn, xs),
                      (lqn, lqs), (lqo, lq_old)):
        np.testing.assert_allclose(np_(got), np_(want), **F64)

    back = params_to_jax(tm)
    flat_a, struct_a = jax.tree_util.tree_flatten(tree)
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "flow.pkl")
    tm.save(path)
    with jax.enable_x64(True):
        loaded = jm.load(path)
        np.testing.assert_allclose(
            np.asarray(jm.log_prob(loaded, jnp.asarray(x))), np_(tlp), **F64)
    other = build_circular_flow(n, 2, BOUND, K=2, hidden_units=HIDDEN,
                                num_bins=BINS, net_type=net_type,
                                device="cpu").double().load(path)
    for p, q in zip(tm.parameters(), other.parameters()):
        assert torch.equal(p, q)


def test_a_tree_goes_only_into_a_flow_of_its_net():
    """A transformer's tree does not load into a gnn or residual flow."""
    _, tree, _ = flows("transformer", 3, 70)
    for other in ("residual", "gnn"):
        with pytest.raises(ValueError, match="keys"):
            params_from_jax(tree, build_circular_flow(
                3, 2, BOUND, K=2, hidden_units=HIDDEN, num_bins=BINS,
                net_type=other, device="cpu"))


# ----- scan_layers=False -----------------------------------------------------

@pytest.mark.parametrize("conditional", [False, True])
def test_unstacked_flow_matches_jax_and_the_stacked_flow(conditional):
    """K ``ParamLayer``s against JAX's unrolled flow (a tuple of K trees),
    and against the port's stacked flow drawn from the same generator:
    the same parameters and the same log q; the independence move takes
    the separate passes."""
    k, n, ctx = 3, 3, 4
    rng = np.random.default_rng(80)
    x = points(81, n if not conditional else 1)
    c = rng.normal(size=(len(x), ctx))
    if conditional:
        jm = j_build_cond(1, 2, BOUND, context_features=ctx, K=k,
                          hidden_units=HIDDEN, num_bins=BINS,
                          scan_layers=False)
        build = lambda scan: build_conditional_circular_flow(  # noqa: E731
            1, 2, BOUND, context_features=ctx, K=k, hidden_units=HIDDEN,
            num_bins=BINS, device="cpu", scan_layers=scan,
            generator=torch.Generator().manual_seed(5)).double()
    else:
        jm = j_build_flow(n, 2, BOUND, K=k, hidden_units=HIDDEN,
                          num_bins=BINS, scan_layers=False)
        build = lambda scan: build_circular_flow(  # noqa: E731
            n, 2, BOUND, K=k, hidden_units=HIDDEN, num_bins=BINS,
            device="cpu", scan_layers=scan,
            generator=torch.Generator().manual_seed(5)).double()
    tree = random_tree(jm.init_params(jax.random.key(0)), 82)
    assert isinstance(tree, tuple) and len(tree) == k
    tm = build(False)
    assert len(tm.layers) == k and all(isinstance(layer, ParamLayer)
                                       for layer in tm.layers)
    stacked_flow = build(True)
    # the stacked flow's K slices are the unstacked flow's K trees
    unstacked = params_to_jax(tm)
    for i in range(k):
        for a, b in zip(jax.tree_util.tree_leaves(unstacked[i]),
                        jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                            lambda v: v[i], params_to_jax(stacked_flow)[0]))):
            np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        lp_unstacked = tm.log_prob(torch.as_tensor(x),
                                   *([torch.as_tensor(c)] * conditional))
        lp_stacked = stacked_flow.log_prob(torch.as_tensor(x),
                                           *([torch.as_tensor(c)]
                                             * conditional))
    np.testing.assert_allclose(np_(lp_unstacked), np_(lp_stacked), **F64)

    params_from_jax(tree, tm)
    with jax.enable_x64(True):
        kw = dict(context=jnp.asarray(c)) if conditional else {}
        want = jm.log_prob(to_jax(tree), jnp.asarray(x), **kw)
    with torch.no_grad():
        cargs = [torch.as_tensor(c)] * conditional
        got = tm.log_prob(torch.as_tensor(x), *cargs)
        # separate passes: log q of the old points is log_prob's
        g = torch.Generator().manual_seed(9)
        if conditional:
            _, _, lqo = tm.sample_and_log_prob_with_old(
                len(x), torch.as_tensor(x), g, torch.as_tensor(c))
        else:
            _, _, lqo = tm.sample_and_log_prob_with_old(
                len(x), torch.as_tensor(x), g)
    np.testing.assert_allclose(np_(got), np.asarray(want), **F64)
    np.testing.assert_allclose(np_(lqo), np_(got), **F64)


# ----- bf16 ------------------------------------------------------------------

def test_bf16_net_matches_jax():
    """The residual net with ``compute_dtype="bfloat16"`` on float32
    weights and inputs against JAX's bf16 net: each rounds its matmuls'
    operands and outputs to bf16 (at places that may differ by one bf16
    step, 2^-8 relative), so the two are held to ``BF16`` of (1 + |JAX|)
    (measured: 0.016 at most on these inputs); both are far from their
    float32 net, which the check shows is not the comparison's scale."""
    kw = dict(in_features=6, out_features=13, hidden_features=HIDDEN,
              num_blocks=2, use_norm=True)
    jnet = jnets.ResidualNet(compute_dtype="bfloat16", **kw)
    jnet32 = jnets.ResidualNet(**kw)
    tnet = tnets.ResidualNet(compute_dtype="bfloat16", **kw)
    tree = random_tree(jnet.init_params(jax.random.key(6)), 90)
    x = np.random.default_rng(91).uniform(-3, 3, (64, 6)).astype(np.float32)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                   tree)
    want = np.asarray(jnet.apply(jtree, jnp.asarray(x)))
    want32 = np.asarray(jnet32.apply(jtree, jnp.asarray(x)))
    got = tnet.apply(to_torch(tree, torch.float32), torch.as_tensor(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(np_(got) - want) / (1.0 + np.abs(want))
    assert err.max() <= BF16, err.max()
    # the bf16 rounding is visible: both bf16 nets are off the float32 one
    assert np.abs(want - want32).max() > 1e-3


def test_bf16_flow_is_mh_consistent_and_keeps_float32_params():
    """``tests/test_bf16.py`` for the port, on seeded weights away from
    the identity init: the fused log q of a sample equals ``log_prob`` of
    it within 5e-3, the round trip within 2e-4, the parameters stay
    float32; and the bf16 flow's tree is the float32 flow's."""
    kw = dict(K=3, hidden_units=32, num_bins=8, device="cpu")
    f32 = build_circular_flow(3, 2, BOUND, **kw,
                              generator=torch.Generator().manual_seed(0))
    bf16 = build_circular_flow(3, 2, BOUND, compute_dtype="bfloat16", **kw,
                               generator=torch.Generator().manual_seed(0))
    for a, b in zip(f32.parameters(), bf16.parameters()):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    tree = tree_map(lambda a: a * 0.0 + np.random.default_rng(
        a.size).normal(0.0, 0.1, a.shape), params_to_jax(bf16))
    params_from_jax(tree, bf16)
    with torch.no_grad():
        x, log_q = bf16.sample_and_log_prob(256,
                                            torch.Generator().manual_seed(2))
        assert x.dtype == torch.float32
        x2 = bf16.forward(bf16.inverse(x))
        lp = bf16.log_prob(x)
    np.testing.assert_allclose(np_(x2), np_(x), rtol=0, atol=2e-4)
    np.testing.assert_allclose(np_(lp), np_(log_q), rtol=0, atol=5e-3)
    assert bool(torch.isfinite(lp).all())


# ----- the drivers with each net ---------------------------------------------

@pytest.mark.parametrize("net_type", ["transformer", "gnn"])
def test_algorithm1_runs_and_saves_with_the_net(net_type, tmp_path):
    """A1 on the CPU at a small width with each net: a finite loss, an
    acceptance in [0, 1], and the saved model a tree of that net that the
    JAX flow of the same build loads and evaluates as the port does."""
    config = algorithm1_config(**a1_config(tmp_path, net_type=net_type))
    res = algorithm1.run(config, device="cpu")
    assert np.isfinite(res["final_loss"])
    assert 0.0 <= res["big_move_acceptance"] <= 1.0
    path = os.path.join(res["directory"], "training_rounds",
                        "initial_training_round",
                        "initial_model_circularspline_res_dense.pkl")
    with open(path, "rb") as f:
        saved = pickle.load(f)
    keys = {"transformer": {"embed", "blocks", "final"},
            "gnn": {"embed", "layers", "final"}}[net_type]
    assert set(saved[0]["net"]) == keys
    hb = config.half_box
    model = build_circular_flow(3, 2, hb, K=2, hidden_units=16, num_bins=4,
                                net_type=net_type, device="cpu").load(path)
    jm = j_build_flow(3, 2, hb, K=2, hidden_units=16, num_bins=4,
                      net_type=net_type)
    x = points(95, 3) * (hb / BOUND)
    with torch.no_grad():
        got = model.log_prob(torch.as_tensor(x, dtype=torch.float32))
    want = jm.log_prob(jm.load(path), jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=1e-3)


def a2_config(out, **kw):
    return test_torch_algorithm2.config(
        out, experiment_id="nets_a2", equilibration_steps=100,
        checkpoint_interval=1, **kw)


@pytest.mark.parametrize("net_type", ["transformer", "gnn"])
def test_algorithm2_resumes_with_the_net(net_type, tmp_path):
    """A2 with each net: 2 cycles resumed to 4 equal an uninterrupted run
    of 4 (chains and flow, bit for bit)."""
    whole = algorithm2.run(a2_config(tmp_path / "whole", net_type=net_type),
                           device="cpu")
    algorithm2.run(a2_config(tmp_path / "cut", net_type=net_type,
                             num_training_cycles=2), device="cpu")
    resumed = algorithm2.run(a2_config(tmp_path / "cut", net_type=net_type),
                             resume=True, device="cpu")
    assert resumed["start_cycle"] == 2 and resumed["cycles_run"] == 2
    assert torch.equal(resumed["state"].positions, whole["state"].positions)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(resumed["model"])),
                    jax.tree_util.tree_leaves(params_to_jax(whole["model"]))):
        np.testing.assert_array_equal(a, b)


def test_blocked_path_builds_the_residual_conditional_flow(tmp_path):
    """The blocked moves' conditional flow is residual whatever
    ``net_type`` says, as the JAX drivers build it (their
    ``build_conditional_circular_flow`` takes no ``net_type``; ROADMAP
    R11); the port logs the net in effect."""
    assert "net_type" not in inspect.signature(j_build_cond).parameters
    res = algorithm1.run(algorithm1_config(**a1_config(
        tmp_path, num_particles=4, blocked_k=1, blocked_K=2,
        net_type="gnn")), device="cpu")
    assert np.isfinite(res["final_loss"])
    path = os.path.join(res["directory"], "training_rounds",
                        "initial_training_round",
                        "initial_model_blocked_conditional.pkl")
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert set(saved[0]["net"]["blocks"][0]) == {"l1", "l2", "ctx"}
    with open(os.path.join(res["directory"], "experiment.log")) as f:
        assert "conditional flow net: residual; net_type=gnn unused" \
            in f.read()


def perturbed(tree, seed):
    """``tree`` (numpy, the JAX layout) redrawn away from the identity
    init as ``chip_smoke.py``'s ``perturbed_tree`` draws it: each linear's
    ``w`` N(0, 0.5 / sqrt(fan_in)), its ``b`` N(0, 0.1), the
    unconditional splines' parameters N(0, 0.3)."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, name) for v in t)
        if name == "w":
            return rng.normal(0.0, 0.5 / np.sqrt(t.shape[-2]), t.shape)
        return rng.normal(0.0, 0.1 if name == "b" else 0.3, t.shape)

    return walk(tree)


def test_bf16_fused_log_q_parts_from_log_prob_off_the_init_in_both():
    """R13: at A1's widths (K=15, hidden 256, 32 bins) on perturbed
    weights, the bf16 flow's log q of a pushed-forward point and the
    inverse pass's ``log_prob`` of it part by more than the 5e-3 that
    ``tests/test_bf16.py`` holds at the identity init, in JAX as in the
    port, on the same 4,096 base points: each layer's round trip moves
    the next layer's input and bf16 rounds the move up.  The bulk stays
    close: the port's 99th percentile within 5e-3 and within twice JAX's
    plus 1e-4."""
    kw = dict(K=15, hidden_units=256, num_bins=32)
    jm = j_build_flow(3, 2, BOUND, compute_dtype="bfloat16", **kw)
    tm = build_circular_flow(3, 2, BOUND, compute_dtype="bfloat16",
                             device="cpu", **kw)
    tree = perturbed(params_to_jax(tm), 35)
    params_from_jax(tree, tm)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    z = np.random.default_rng(36).uniform(-BOUND, BOUND, (4096, 6))
    z = z.astype(np.float32)
    x, ld = jm.forward_and_log_det(jp, jnp.asarray(z))
    j_gap = np.abs(np.asarray(-ld - jm.log_prob(jp, x)
                              + jm.base.log_prob(jnp.asarray(z))))
    with torch.no_grad():
        tx, tld = tm.forward_and_log_det(torch.as_tensor(z))
        t_gap = (-tld - tm.log_prob(tx)
                 + tm.base.log_prob(torch.as_tensor(z))).abs().numpy()
    assert j_gap.max() > 5e-3 and t_gap.max() > 5e-3, (j_gap.max(),
                                                       t_gap.max())
    j99, t99 = np.percentile(j_gap, 99), np.percentile(t_gap, 99)
    print(f"bf16 fused log q - log_prob: JAX max {j_gap.max():.4g} 99th "
          f"percentile {j99:.3g}; port max {t_gap.max():.4g} 99th "
          f"percentile {t99:.3g}")
    assert t99 <= 5e-3 and t99 <= 2 * j99 + 1e-4, (t99, j99)
