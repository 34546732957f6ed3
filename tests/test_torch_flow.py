"""The port's flow (``flowstate_tpu_torch.ops.splines`` and ``.flows``)
against the JAX package's on the same weights and inputs.

Weights are a seeded numpy tree in the JAX layout, moved into the port by
``params_from_jax`` and into JAX inside ``jax.enable_x64`` (outside it
``jnp.asarray`` would round them to float32).  JAX runs in float64; the
port is held to it to 1e-10 in float64; in float32, to JAX's own float32
error (see ``test_flow_matches_jax_in_float32``).
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.flows.core import build_circular_flow as j_build_flow
from flowstate_tpu.flows.coupling import (
    CircularSplineCoupling as JCoupling,
)
from flowstate_tpu.ops import splines as jsplines
from flowstate_tpu_torch.flows import (
    CircularSplineCoupling, build_circular_flow, params_from_jax,
    params_to_jax, tree_map,
)
from flowstate_tpu_torch.ops import splines as tsplines

torch.set_num_threads(1)

N, DIM, BOUND = 3, 2, 5.0
HIDDEN, BINS = 16, 4
F64 = dict(rtol=1e-10, atol=1e-10)


def random_tree(shapes, seed, scale=0.4):
    """A numpy tree shaped like ``shapes`` (a JAX pytree) with N(0, scale)
    leaves, far from the identity init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, scale, np.shape(a)), shapes)


def to_jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def to_torch(tree, dtype):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a), dtype=dtype),
                    tree)


def np_(t):
    return t.detach().numpy()


def flows(k, seed, dtype=torch.float64):
    """The JAX flow, the port's flow and one numpy tree of weights for
    both; JAX's parameters come back as float64 arrays (call inside
    ``enable_x64``)."""
    jmodel = j_build_flow(N, DIM, BOUND, K=k, hidden_units=HIDDEN,
                          num_bins=BINS)
    tree = random_tree(jmodel.init_params(jax.random.key(0)), seed)
    tmodel = build_circular_flow(N, DIM, BOUND, K=k, hidden_units=HIDDEN,
                                 num_bins=BINS, device="cpu").to(dtype)
    params_from_jax(tree, tmodel)
    return jmodel, to_jax(tree), tmodel, tree


def inputs(seed, m=41, edges=False):
    """Points on the torus; with ``edges``, its corners and edges among
    them.  A layer maps the edge to the edge up to rounding, and the next
    layer's tail rule (identity outside the bound) switches on the last
    bit, so edge points are held to JAX at the spline and the single
    layer, and chains of layers take points inside the torus."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-BOUND, BOUND, size=(m, N * DIM))
    if edges:
        x[0] = -BOUND
        x[1] = BOUND
        x[2, ::2] = -BOUND
    x[3] = 0.0
    return x


# ----- the spline ----------------------------------------------------------

def spline_params(seed, batch):
    """Widths, heights and the derivatives of circular tails (one slot
    per bin: the last knot's is tied to the first)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1.0, (batch, BINS)) for _ in range(3))


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_jax_at_knots_and_edges(inverse):
    batch = 64
    uw, uh, ud = spline_params(3, batch)
    with jax.enable_x64(True):
        # the knots of each row: inputs exactly on them, and just inside
        # the interval's ends, pick the bin by the comparison sum
        knots, _ = jsplines._knots(jnp.asarray(uh if inverse else uw),
                                   1e-3, -BOUND, BOUND)
        knots = np.array(knots)
        col = np.arange(batch) % (BINS + 1)
        x = knots[np.arange(batch), col]
        x[::7] = np.nextafter(BOUND, 0.0)
        x[3::7] = -BOUND
        x[5::11] += 1e-7
        j_out, j_ld = jsplines.unconstrained_rational_quadratic_spline(
            jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh),
            jnp.asarray(ud), inverse=inverse, tails="circular",
            tail_bound=BOUND)
        j_idx = jsplines._searchsorted(jnp.asarray(knots), jnp.asarray(x))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    t_out, t_ld = tsplines.unconstrained_rational_quadratic_spline(
        t(x), t(uw), t(uh), t(ud), inverse=inverse, tails="circular",
        tail_bound=BOUND)
    t_idx = tsplines._searchsorted(t(knots), t(x))
    np.testing.assert_array_equal(np_(t_idx), np.asarray(j_idx))
    np.testing.assert_allclose(np_(t_out), np.asarray(j_out), **F64)
    np.testing.assert_allclose(np_(t_ld), np.asarray(j_ld), **F64)


@pytest.mark.parametrize("tails", ["linear", "circular",
                                   ("circular", "linear", "circular")])
@pytest.mark.parametrize("tie", [True, False])
def test_pad_derivatives_matches_jax(tails, tie):
    d = np.random.default_rng(5).normal(size=(7, 3, BINS + 1))
    with jax.enable_x64(True):
        j = jsplines._pad_derivatives(jnp.asarray(d), tails, circular_tie=tie)
    t = tsplines._pad_derivatives(torch.as_tensor(d), tails, circular_tie=tie)
    np.testing.assert_array_equal(np_(t), np.asarray(j))
    assert tsplines.IDENTITY_DERIVATIVE_CONSTANT == \
        jsplines.IDENTITY_DERIVATIVE_CONSTANT


# ----- one coupling layer --------------------------------------------------

@pytest.mark.parametrize("reverse_mask", [False, True])
def test_coupling_matches_jax(reverse_mask):
    kw = dict(features=N * DIM, num_blocks=2, hidden_units=HIDDEN,
              ind_circ=tuple(range(N * DIM)), num_bins=BINS,
              tail_bound=BOUND, reverse_mask=reverse_mask)
    jlayer = JCoupling(**kw)
    tlayer = CircularSplineCoupling(**kw)
    tree = random_tree(jlayer.init_params(jax.random.key(1)), 11)
    x = inputs(12, edges=True)
    p = to_torch(tree, torch.float64)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        for name in ("forward", "inverse"):
            jy, jld = getattr(jlayer, name)(jp, jnp.asarray(x))
            ty, tld = getattr(tlayer, name)(p, torch.as_tensor(x))
            np.testing.assert_allclose(np_(ty), np.asarray(jy), **F64)
            np.testing.assert_allclose(np_(tld), np.asarray(jld), **F64)


# ----- the whole flow ------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
def test_flow_matches_jax_in_float64(k):
    x = inputs(20 + k)
    z = inputs(30 + k)
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(k, 40 + k)
        jy, jld = jm.forward_and_log_det(jp, jnp.asarray(z))
        jz, jild = jm.inverse_and_log_det(jp, jnp.asarray(x))
        jlp = jm.log_prob(jp, jnp.asarray(x))
    with torch.no_grad():
        ty, tld = tm.forward_and_log_det(torch.as_tensor(z))
        tz, tild = tm.inverse_and_log_det(torch.as_tensor(x))
        tlp = tm.log_prob(torch.as_tensor(x))
        back = tm.inverse(ty)
    for t, j in ((ty, jy), (tld, jld), (tz, jz), (tild, jild), (tlp, jlp)):
        np.testing.assert_allclose(np_(t), np.asarray(j), **F64)
    np.testing.assert_allclose(np_(back), z, rtol=0, atol=1e-9)


def test_flow_matches_jax_in_float32():
    """In float32 the port is held to JAX's float64 result as closely as
    JAX's own float32 run is: max error <= 2 x JAX's float32 max error +
    1e-5.  (JAX's float32 log-det at K=3 is 7e-5 off its float64 one on
    these inputs, so a flat 1e-5 would fail the reference itself.)"""
    x = inputs(50)
    z = inputs(51)
    with jax.enable_x64(True):
        jm, jp, tm, tree = flows(3, 52, dtype=torch.float32)
        want = (*jm.forward_and_log_det(jp, jnp.asarray(z)),
                jm.log_prob(jp, jnp.asarray(x)))
    jp32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    j32 = (*jm.forward_and_log_det(jp32, jnp.asarray(z, jnp.float32)),
           jm.log_prob(jp32, jnp.asarray(x, jnp.float32)))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        got = (*tm.forward_and_log_det(f32(z)), tm.log_prob(f32(x)))
    for name, t, j, w in zip(("x", "log_det", "log_prob"), got, j32, want):
        w = np.asarray(w)
        port_err = np.abs(np_(t) - w).max()
        jax_err = np.abs(np.asarray(j) - w).max()
        assert port_err <= 2 * jax_err + 1e-5, (name, port_err, jax_err)


def test_identity_init_log_prob():
    tm = build_circular_flow(N, DIM, BOUND, K=3, hidden_units=HIDDEN,
                             num_bins=BINS, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x = torch.as_tensor(inputs(60, edges=True), dtype=torch.float32)
    with torch.no_grad():
        lp = tm.log_prob(x)
        back = tm.forward(tm.inverse(x))
    np.testing.assert_allclose(np_(lp), -N * DIM * math.log(2 * BOUND),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_(back), np_(x), rtol=0, atol=1e-5)
    outside = x.clone()
    outside[0, 0] = BOUND + 1.0
    assert torch.isneginf(tm.base.log_prob(outside))[0]


@pytest.mark.parametrize("k", [2, 3])
def test_paired_pass_matches_separate_passes_and_jax(k):
    z = inputs(70 + k)
    x = inputs(80 + k)
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(k, 90 + k)
        (jyf, jldf), (jzi, jldi) = jm.layers[0].paired_forward_inverse(
            jp[0], jnp.asarray(z), jnp.asarray(x))
    with torch.no_grad():
        (yf, ldf), (zi, ldi) = tm.layers[0].paired_forward_inverse(
            torch.as_tensor(z), torch.as_tensor(x))
        sy, sld = tm.forward_and_log_det(torch.as_tensor(z))
        sz, sild = tm.inverse_and_log_det(torch.as_tensor(x))
        # the flow's entry point: the same proposal's log q both ways
        g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
        xn, lqn, lqo = tm.sample_and_log_prob_with_old(9, torch.as_tensor(
            x[:9]), g())
        xs, lqs = tm.sample_and_log_prob(9, g())
    for t, s in ((yf, sy), (ldf, sld), (zi, sz), (ldi, sild), (xn, xs),
                 (lqn, lqs)):
        np.testing.assert_allclose(np_(t), np_(s), **F64)
    np.testing.assert_allclose(np_(lqo), np_(tm.log_prob(torch.as_tensor(
        x[:9])).detach()), **F64)
    for t, j in ((yf, jyf), (ldf, jldf), (zi, jzi), (ldi, jldi)):
        np.testing.assert_allclose(np_(t), np.asarray(j), **F64)


def test_params_round_trip_and_save_load(tmp_path):
    with jax.enable_x64(True):
        _, _, tm, tree = flows(2, 100)
    back = params_to_jax(params_from_jax(tree, tm))
    flat_a, struct_a = jax.tree_util.tree_flatten(tuple(tree) if isinstance(
        tree, tuple) else (tree,))
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the port's file: the JAX layout, loadable by either package
    path = tmp_path / "initial_model_circularspline_res_dense.pkl"
    tm.save(str(path))
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert jax.tree_util.tree_structure(saved) == struct_a
    other = build_circular_flow(N, DIM, BOUND, K=2, hidden_units=HIDDEN,
                                num_bins=BINS, device="cpu").double()
    other.load(str(path))
    for p, q in zip(tm.parameters(), other.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, build_circular_flow(
            N, DIM, BOUND, K=3, hidden_units=HIDDEN, num_bins=BINS,
            device="cpu"))


@pytest.mark.parametrize("net_type", ["transformer", "gnn"])
def test_other_nets_are_not_ported_yet(net_type):
    """The name is kept from when only the residual net was ported.  Now:
    a context reaches the residual net only.  JAX raises ValueError when
    a transformer or gnn coupling with a context builds its net; the port
    raises the same error when the layer is built.  An unknown net is
    refused too."""
    kw = dict(features=6, num_blocks=2, hidden_units=16,
              ind_circ=tuple(range(6)), net_type=net_type,
              context_features=4)
    with pytest.raises(ValueError, match="residual backend"):
        JCoupling(**kw).init_params(jax.random.key(0))
    with pytest.raises(ValueError, match="residual backend"):
        CircularSplineCoupling(**kw)
    with pytest.raises(ValueError, match="net_type"):
        CircularSplineCoupling(6, 2, 16, tuple(range(6)), net_type="mlp")
    layer = CircularSplineCoupling(**{**kw, "context_features": None})
    assert layer.net_type == net_type
