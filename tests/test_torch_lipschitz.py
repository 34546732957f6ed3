"""The port's induced-norm Lipschitz layers (``flowstate_tpu_torch.flows.
lipschitz``) against the JAX package's, and against closed-form operator
norms.

Trees are JAX's own init (the power-iteration vectors included) as numpy,
or off the Euclidean case, where JAX's eager init of 11 x 200 steps takes
seconds, the port's init carried out by ``params_to_jax``; either is
handed to JAX inside ``jax.enable_x64`` and to the port as float64
tensors or carried by ``params_from_jax``.  Tolerances:

* float64 on both sides, the same arithmetic: 1e-10 (``F64``), the
  power iteration's 200-300 steps included;
* gradients against ``jax.grad`` in float64: 1e-9 (``GRAD``);
* the closed-form norms (``||W||_{1->q}`` the largest column q-norm,
  ``||W||_{p->inf}`` the largest dual row norm, ``||W||_{2->2}`` the top
  singular value, ``||W||_{inf->inf}`` the largest row abs-sum), on the
  port's own init: the converged iteration within [0.95, 1.001] of the
  closed form (``tests/test_lipschitz.py``'s bounds), the conv's
  operator norm from its dense matrix within 1e-3.

Sizes are small: 6 x 5 weights, 2-3 channels on 4 x 4 to 6 x 6 fields.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowstate_tpu.flows as jflows
import flowstate_tpu_torch.flows as tflows
from flowstate_tpu_torch.flows import (
    NormalizingFlow, ParamLayer, params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.flows import lipschitz as tlip

from test_torch_flow import F64, np_, to_jax, to_torch

torch.set_num_threads(1)

F64_T = torch.float64
GRAD = dict(rtol=1e-9, atol=1e-9)
INF = math.inf


def assert_close(got, want, **tol):
    got = np_(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or F64))


def jax_tree(layer, seed):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            layer.init_params(jax.random.key(seed)))


def init_tree(jl, tl, seed):
    """JAX's init tree for a Euclidean layer; off it (JAX's eager init of
    11 x 200 steps takes seconds) the port's, carried out by
    ``params_to_jax``."""
    if not tl.learnable_ord and tl.domain == 2 and tl.codomain == 2:
        return jax_tree(jl, seed)
    layer = ParamLayer(tl, torch.Generator().manual_seed(seed),
                       dtype=F64_T, device="cpu")
    return params_to_jax(layer)


# ----- the vector helpers -------------------------------------------------

@pytest.mark.parametrize("p", [1.0, 1.5, 2.0, 3.0, "tensor"])
def test_vector_norm_and_its_gradient_match_jax(p):
    """The value and ``jax.grad`` in x and (for a tensor p) in p, at an
    exact zero entry too: finite on both sides."""
    x = np.array([0.3, -1.2, 0.0, 2.5, -0.7])
    p_val = 2.7 if p == "tensor" else p
    with jax.enable_x64(True):
        j_val = jflows.vector_norm(jnp.asarray(x), jnp.asarray(p_val))
        jgx, jgp = jax.grad(lambda a, q: jflows.vector_norm(a, q),
                            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p_val))
    tx = torch.as_tensor(x).requires_grad_()
    tp = (torch.tensor(p_val, dtype=F64_T, requires_grad=True)
          if p == "tensor" else p)
    val = tflows.vector_norm(tx, tp)
    assert_close(val.detach(), j_val)
    grads = torch.autograd.grad(val, [tx, tp] if p == "tensor" else [tx])
    assert_close(grads[0], jgx)
    assert np.all(np.isfinite(np_(grads[0])))
    if p == "tensor":
        assert_close(grads[1], jgp)
        assert np.isfinite(float(grads[1]))


def test_projmax_keeps_the_sign_and_takes_the_first_maximum():
    for v in ([0.3, -2.0, 1.0, 2.0], [1.0, -1.0, 0.5], [0.0, 0.0, -0.0],
              [-0.1, 0.2, -0.3]):
        with jax.enable_x64(True):
            want = jflows.projmax(jnp.asarray(v, jnp.float64))
        got = tflows.projmax(torch.as_tensor(v, dtype=F64_T))
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    got = np_(tflows.projmax(torch.tensor([0.3, -2.0, 1.0, 2.0])))
    np.testing.assert_array_equal(got, [0.0, -1.0, 0.0, 0.0])


ORDERS = [1, 2, 1.5, 3.0, INF, "tensor"]


@pytest.mark.parametrize("order", ORDERS, ids=str)
def test_normalize_u_and_v_match_jax(order):
    """Every branch: 1, 2, inf, a finite p and a tensor p (the learnable
    orders' branch); zero entries included."""
    v = np.array([0.4, -1.3, 0.0, 0.9, -0.2, 1.3])
    o = np.asarray(2.4) if order == "tensor" else order
    with jax.enable_x64(True):
        jo = jnp.asarray(o) if order == "tensor" else o
        want_v = jflows.normalize_v(jnp.asarray(v), jo)
        want_u = jflows.normalize_u(jnp.asarray(v), jo)
    to = torch.as_tensor(o) if order == "tensor" else o
    assert_close(tflows.normalize_v(torch.as_tensor(v), to), want_v)
    assert_close(tflows.normalize_u(torch.as_tensor(v), to), want_u)


def test_kaiming_uniform_bound():
    w = tlip._kaiming_uniform(torch.Generator().manual_seed(0), 8, 3, 3, 3,
                              dtype=F64_T, device="cpu")
    assert w.shape == (8, 3, 3, 3)
    bound = 1.0 / math.sqrt(27)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound


# ----- InducedNormLinear ---------------------------------------------------

LINEAR_ORDERS = [(2, 2), (1, 2), (2, INF), (1, INF), (1, 1), (INF, INF),
                 (1.5, 3.0)]


@pytest.mark.parametrize("domain,codomain", LINEAR_ORDERS, ids=str)
def test_linear_matches_jax(domain, codomain):
    """``apply``, ``compute_weight`` and ``update_lipschitz`` on JAX's
    init tree (its 200 steps and restarts), and 300 more steps."""
    kw = dict(domain=domain, codomain=codomain, coeff=0.5)
    jl, tl = (jflows.InducedNormLinear(6, 5, **kw),
              tflows.InducedNormLinear(6, 5, **kw))
    tree = jax_tree(jl, 0)
    x = np.random.default_rng(1).normal(size=(4, 6))
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        assert_close(tl.apply(tp, torch.as_tensor(x)),
                     jl.apply(jp, jnp.asarray(x)))
        assert_close(tl.compute_weight(tp), jl.compute_weight(jp))
        j_upd = jl.update_lipschitz(jp, 300)
    t_upd = tl.update_lipschitz(tp, 300)
    for k in ("u", "v"):
        assert_close(t_upd[k], j_upd[k])


@pytest.mark.parametrize("domain,codomain", LINEAR_ORDERS[:6], ids=str)
def test_linear_induced_norm_matches_closed_form(domain, codomain):
    """The port's init and 300 steps against the closed forms."""
    layer = tflows.InducedNormLinear(6, 5, domain=domain, codomain=codomain,
                                     coeff=0.9)
    params = layer.update_lipschitz(layer.init_params(
        torch.Generator().manual_seed(2), dtype=F64_T, device="cpu"), 300)
    w = np_(params["w"])
    if (domain, codomain) == (2, 2):
        exact = np.linalg.svd(w, compute_uv=False)[0]
    elif domain == 1:
        exact = max(np.linalg.norm(w[:, j], ord=codomain)
                    for j in range(w.shape[1]))
    elif codomain == INF and domain == 2:
        exact = max(np.linalg.norm(w[i], ord=2) for i in range(w.shape[0]))
    else:   # inf -> inf: the largest row abs-sum
        exact = np.abs(w).sum(axis=1).max()
    sigma = abs(float(torch.dot(params["u"], params["w"] @ params["v"])))
    assert exact * 0.95 <= sigma <= exact * 1.001, (sigma, exact)


def test_linear_soft_normalisation():
    """Above ``coeff`` the normalised weight's spectral norm is ``coeff``;
    below it the weight is untouched (``tests/test_lipschitz.py``)."""
    layer = tflows.InducedNormLinear(8, 8, coeff=0.5, bias=False)
    params = layer.init_params(torch.Generator().manual_seed(1),
                               dtype=F64_T, device="cpu")
    assert set(params) == {"w", "u", "v"}
    top = torch.linalg.matrix_norm(params["w"], ord=2)
    params["w"] = params["w"] * (2.0 / top)
    params = layer.update_lipschitz(params, 200)
    top_n = float(torch.linalg.matrix_norm(layer.compute_weight(params),
                                           ord=2))
    assert top_n == pytest.approx(0.5, rel=1e-3)
    params["w"] = params["w"] * 0.1
    params = layer.update_lipschitz(params, 50)
    assert torch.equal(layer.compute_weight(params), params["w"])


def test_learnable_orders_and_compute_one_iter_match_jax_grad():
    """``compute_one_iter``'s value and ``jax.grad``: the raw orders take a
    gradient, the weight, ``u`` and ``v`` none; the orders squashed into
    (1, 5)."""
    jl = jflows.InducedNormLinear(5, 4, domain=0.0, codomain=0.5,
                                  learnable_ord=True)
    tl = tflows.InducedNormLinear(5, 4, domain=0.0, codomain=0.5,
                                  learnable_ord=True)
    tree = jax_tree(jl, 5)
    assert np.shape(tree["domain_raw"]) == ()
    with jax.enable_x64(True):
        jp = to_jax(tree)
        j_val, j_grad = jax.value_and_grad(jl.compute_one_iter)(jp)
    layer = ParamLayer(tl, device="cpu").double()
    params_from_jax(tree, layer)
    ptree = layer.params.tree()
    val = tl.compute_one_iter(ptree)
    assert_close(val.detach(), j_val)
    val.backward()
    for k in tree:
        g = ptree[k].grad
        g = torch.zeros_like(ptree[k]) if g is None else g
        assert_close(g, j_grad[k], **GRAD)
    assert float(ptree["domain_raw"].grad) != 0.0
    assert all(ptree[k].grad is None or not torch.any(ptree[k].grad)
               for k in ("w", "u", "v"))
    d = float(tflows.asym_squash(ptree["domain_raw"]))
    assert 1.0 < d < 5.0


def test_linear_init_restarts_off_the_euclidean_case():
    """Off 2 -> 2 the init keeps the best of 11 runs, so its sigma is at
    least a single run's: the same generator state replayed gives the
    first run alone."""
    layer = tflows.InducedNormLinear(6, 5, domain=1, codomain=INF)
    params = layer.init_params(torch.Generator().manual_seed(3),
                               dtype=F64_T, device="cpu")
    best = float(torch.dot(params["u"], params["w"] @ params["v"]))
    g = torch.Generator().manual_seed(3)
    w = tlip._kaiming_uniform(g, 5, 6, dtype=F64_T, device="cpu")
    tlip._uniform(g, 5, 1.0, F64_T, "cpu")
    u0 = tflows.normalize_u(torch.randn(5, generator=g, dtype=F64_T), INF)
    v0 = tflows.normalize_v(torch.randn(6, generator=g, dtype=F64_T), 1)
    torch.testing.assert_close(w, params["w"], rtol=0, atol=0)
    _, _, first = layer._power_iter(w, u0, v0, 1, INF, 200)
    assert best >= float(first)
    assert best == pytest.approx(np.abs(np_(w)).max(), rel=1e-12)


# ----- InducedNormConv2d ----------------------------------------------------

CONVS = {
    "3x3": dict(in_channels=2, out_channels=3, kernel_size=3,
                spatial_dims=(4, 4)),
    "3x3_stride2": dict(in_channels=2, out_channels=3, kernel_size=3,
                        spatial_dims=(5, 5), stride=2),
    "1x1_l1": dict(in_channels=3, out_channels=4, kernel_size=1,
                   spatial_dims=(3, 3), domain=1, codomain=2),
    "learnable": dict(in_channels=2, out_channels=2, kernel_size=3,
                      spatial_dims=(4, 4), domain=0.0, codomain=0.0,
                      learnable_ord=True),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(name):
    """``apply``, ``compute_weight``, ``update_lipschitz`` and
    ``compute_one_iter`` with its gradient, on JAX's init tree; with
    stride 2 the adjoint (the conv's own gradient) stays exact."""
    jl = jflows.InducedNormConv2d(**CONVS[name], coeff=0.5)
    tl = tflows.InducedNormConv2d(**CONVS[name], coeff=0.5)
    tree = init_tree(jl, tl, 6)
    c, (h, w) = jl.in_channels, jl.spatial_dims
    x = np.random.default_rng(7).normal(size=(2, c, h, w))
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        assert_close(tl.apply(tp, torch.as_tensor(x)),
                     jl.apply(jp, jnp.asarray(x)))
        assert_close(tl.compute_weight(tp), jl.compute_weight(jp))
        j_upd = jl.update_lipschitz(jp, 7)
        j_val, j_grad = jax.value_and_grad(jl.compute_one_iter)(jp)
    t_upd = tl.update_lipschitz(tp, 7)
    for k in ("u", "v"):
        assert_close(t_upd[k], j_upd[k])
    layer = ParamLayer(tl, device="cpu").double()
    params_from_jax(tree, layer)
    ptree = layer.params.tree()
    val = tl.compute_one_iter(ptree)
    assert_close(val.detach(), j_val)
    if tl.learnable_ord:
        val.backward()
        for k in ("domain_raw", "codomain_raw"):
            assert_close(ptree[k].grad, j_grad[k], **GRAD)
            assert float(ptree[k].grad) != 0.0
    else:
        assert not val.requires_grad


def dense_operator(layer, w):
    """The conv's matrix (n_out, n_in), column by column."""
    c, (h, wid) = layer.in_channels, layer.spatial_dims
    eye = torch.eye(c * h * wid, dtype=F64_T).reshape(-1, c, h, wid)
    return layer._conv(w, eye).reshape(c * h * wid, -1).T


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv_norm_matches_the_dense_operator(kernel):
    """sigma against the top singular value of the conv's dense matrix;
    the normalised conv's norm at most ``coeff``."""
    layer = tflows.InducedNormConv2d(2, 3, kernel, spatial_dims=(4, 4),
                                     coeff=0.9)
    params = layer.update_lipschitz(layer.init_params(
        torch.Generator().manual_seed(8), dtype=F64_T, device="cpu"), 300)
    exact = float(torch.linalg.matrix_norm(dense_operator(layer,
                                                          params["w"]), 2))
    sigma = float(torch.dot(params["u"], layer._wv(params["w"],
                                                   params["v"])))
    assert sigma == pytest.approx(exact, rel=1e-3)
    top = float(torch.linalg.matrix_norm(
        dense_operator(layer, layer.compute_weight(params)), 2))
    assert top <= 0.9 * 1.001


# ----- the stacks and the residual block ------------------------------------

STACKS = {
    "mlp": (lambda m: m.InducedNormMLP((3, 16, 3), coeff=0.9), (8, 3)),
    "mlp_l1_inf": (lambda m: m.InducedNormMLP((3, 8, 3), coeff=0.9,
                                              domain=1, codomain=INF),
                   (8, 3)),
    "cnn": (lambda m: m.InducedNormCNN((2, 4, 2), kernel_size=(3, 3),
                                       spatial_dims=(5, 5), coeff=0.9),
            (3, 2, 5, 5)),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stacks_match_jax(name):
    """``apply``, ``update_lipschitz`` and ``compute_one_iter`` on JAX's
    init tree (``beta`` a 0-d leaf); the last layer's weight a
    thousandth of the first's scale."""
    make, shape = STACKS[name]
    jn, tn = make(jflows), make(tflows)
    tree = (jax_tree(jn, 9) if name != "mlp_l1_inf" else params_to_jax(
        ParamLayer(tn, torch.Generator().manual_seed(9), dtype=F64_T,
                   device="cpu")))
    assert np.shape(tree[0]["beta"]) == ()
    tree[-1]["w"] = tree[-1]["w"] * 300.0   # off the near-zero init
    x = np.random.default_rng(10).normal(size=shape)
    tp = to_torch(tree, F64_T)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        assert_close(tn.apply(tp, torch.as_tensor(x)),
                     jn.apply(jp, jnp.asarray(x)))
        j_upd = jn.update_lipschitz(jp, 5)
        assert_close(tn.compute_one_iter(tp), jn.compute_one_iter(jp))
    for a, b in zip(tn.update_lipschitz(tp, 5), j_upd):
        for k in ("u", "v", "beta"):
            assert_close(a[k], b[k])
    own = tn.init_params(torch.Generator().manual_seed(11), dtype=F64_T,
                         device="cpu")
    assert float(own[-1]["w"].abs().max()) < 1e-3
    assert float(own[0]["w"].abs().max()) > 1e-2
    assert float(own[0]["beta"]) == 0.5 and own[0]["beta"].dim() == 0


def test_induced_norm_mlp_contracts():
    net = tflows.InducedNormMLP((3, 16, 3), coeff=0.9)
    params = net.update_lipschitz(net.init_params(
        torch.Generator().manual_seed(8), dtype=F64_T, device="cpu"), 100)
    params[-1]["w"] = params[-1]["w"] * 1000.0
    params = net.update_lipschitz(params, 100)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(64, 3, generator=g, dtype=F64_T)
    y = x + 0.1 * torch.randn(64, 3, generator=g, dtype=F64_T)
    ratio = (torch.linalg.norm(net.apply(params, x) - net.apply(params, y),
                               dim=-1) / torch.linalg.norm(x - y, dim=-1))
    assert float(ratio.max()) < 0.9 ** 2 + 1e-4


def test_induced_norm_residual_flow_carries_jax_trees():
    """A flow of ``Residual(InducedNormMLP)`` blocks (the exact log-det;
    ``beta`` 0-d leaves in list-rooted nets) and an ``InducedNormCNN``
    block's tree, carried by ``params_from_jax`` and back: log q and the
    round trip against JAX's."""
    def build(m, place=None):
        layers = (m.Residual(m.InducedNormMLP((2, 8, 2), coeff=0.9),
                             estimator="exact", dim=2, reverse=False),
                  m.ActNorm(2),
                  m.Residual(m.InducedNormMLP((2, 8, 8, 2), coeff=0.9),
                             estimator="exact", dim=2))
        if place is None:
            return m.NormalizingFlow(m.DiagGaussian(2), layers)
        return NormalizingFlow(m.DiagGaussian(2), [place(l) for l in layers],
                               device="cpu")

    jm = build(jflows)
    tm = build(tflows, lambda l: ParamLayer(l, device="cpu")).double()
    with jax.enable_x64(True):
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                      jm.init_params(jax.random.key(12)))
    for block in (0, 2):
        tree[block]["net"][-1]["w"] = tree[block]["net"][-1]["w"] * 300.0
    params_from_jax(tree, tm)
    back = params_to_jax(tm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(13).normal(size=(6, 2))
    with jax.enable_x64(True):
        jp = to_jax(tree)
        want = jm.log_prob(jp, jnp.asarray(x))
        j_z = jm.inverse(jp, jnp.asarray(x))
    tx = torch.as_tensor(x)
    assert_close(tm.log_prob(tx).detach(), want)
    z = tm.inverse(tx)
    assert_close(z.detach(), j_z)
    assert_close(tm.forward(z).detach(), x, rtol=1e-8, atol=1e-8)

    cnn = jflows.InducedNormCNN((2, 4, 2), (3, 3), (4, 4))
    cnn_tree = jax.tree_util.tree_map(np.asarray, jflows.Residual(
        cnn).init_params(jax.random.key(14)))
    layer = ParamLayer(tflows.Residual(tflows.InducedNormCNN(
        (2, 4, 2), (3, 3), (4, 4))), device="cpu")
    params_from_jax(cnn_tree, layer)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(layer)),
                    jax.tree_util.tree_leaves(cnn_tree)):
        np.testing.assert_array_equal(a, b)
