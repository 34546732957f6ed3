"""The port's blocked conditional moves against the JAX package's.

``flowstate_tpu_torch.flows`` (the context GLU, the conditional flow) and
``.mcmc.blocked`` on the same inputs as
``flowstate_tpu``: weights are a seeded numpy tree in the JAX layout
carried by ``params_from_jax`` (the two packages' seeded inits differ:
JAX appends the ``ctx`` keys), data from numpy.  float64 runs inside
``jax.enable_x64`` and is held to 1e-10; float32 to 1e-5.  The blocked
move takes JAX's draws, rebuilt here from its key derivation
(``flowstate_tpu/mcmc/blocked.py:169-175``): the MH log-ratios are held
to 1e-5 relative, and the accept flags agree except where
``|exp(ratio_log) - u|`` is within ``NEAR_TIE`` (ROADMAP R2).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.flows import (
    ConditionalNormalizingFlow as JConditionalFlow,
    build_conditional_circular_flow as j_build_cond,
)
from flowstate_tpu.flows.nets import ResidualNet as JResidualNet
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.flows import (
    ResidualNet, build_circular_flow, build_conditional_circular_flow,
    params_from_jax, params_to_jax, tree_map,
)

from test_torch_flow import random_tree, to_jax, to_torch

torch.set_num_threads(1)

HB, HIDDEN, BINS, M_MAX = 5.0, 16, 5, 3
CTX = 2 * (2 * M_MAX + 1) ** 2
F64 = dict(rtol=1e-10, atol=1e-10)
NEAR_TIE = 1e-5
WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def np_(t):
    return t.detach().numpy()


def positions(seed, b, n, box=2 * HB):
    return np.random.default_rng(seed).uniform(0.0, box, (b, n, 2))


def perms(seed, b, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(b)])


def onehots(perm, k):
    """JAX's (sel, rest) one-hot selectors of a permutation."""
    n = perm.shape[1]
    onehot = (perm[:, :, None] == np.arange(n)[None, None, :]).astype(
        np.float32)
    return onehot[:, :k], onehot[:, k:]


def cond_flows(k, seed, K=3, hidden=HIDDEN, ctx=CTX, dtype=torch.float64,
               scale=0.4):
    """The JAX conditional flow, the port's, and one numpy tree of
    weights for both (shaped by the port's tree: the JAX init's is the
    same, ``test_save_load_in_jax_and_shape_checks``, and slow to
    trace)."""
    jm = j_build_cond(k, 2, HB, context_features=ctx, K=K,
                      hidden_units=hidden, num_bins=BINS)
    tm = build_conditional_circular_flow(
        k, 2, HB, context_features=ctx, K=K, hidden_units=hidden,
        num_bins=BINS, device="cpu").to(dtype)
    tree = random_tree(params_to_jax(tm), seed, scale)
    params_from_jax(tree, tm)
    return jm, tree, tm


# ----- selection and context -------------------------------------------

@pytest.mark.parametrize("n,k", [(4, 1), (8, 1), (8, 2)])
def test_select_and_scatter_equal_jax_bit_for_bit(n, k):
    b = 33
    pos = positions(1, b, n).astype(np.float32)
    perm = perms(2, b, n)
    block = positions(3, b, k).astype(np.float32)
    sel, rest = onehots(perm, k)
    j_sel = jmcmc.select_particles(jnp.asarray(sel), jnp.asarray(pos))
    j_rest = jmcmc.select_particles(jnp.asarray(rest), jnp.asarray(pos))
    j_scat = jmcmc.scatter_block(jnp.asarray(sel), jnp.asarray(block),
                                 jnp.asarray(pos))
    tp, tperm = torch.as_tensor(pos), torch.as_tensor(perm)
    np.testing.assert_array_equal(
        np_(tmcmc.select_particles(tperm[:, :k], tp)), np.asarray(j_sel))
    np.testing.assert_array_equal(
        np_(tmcmc.select_particles(tperm[:, k:], tp)), np.asarray(j_rest))
    np.testing.assert_array_equal(
        np_(tmcmc.scatter_block(tperm[:, :k], torch.as_tensor(block), tp)),
        np.asarray(j_scat))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,k", [(4, 1), (8, 2)])
def test_contexts_match_jax(dtype, n, k):
    b = 29
    pos = positions(4, b, n).astype(dtype)
    perm = perms(5, b, n)
    _, rest = onehots(perm, k)
    tol = F64 if dtype == "float64" else dict(rtol=0, atol=1e-5)
    tp, trest = torch.as_tensor(pos), torch.as_tensor(perm[:, k:])
    with jax.enable_x64(dtype == "float64"):
        jr = jnp.asarray(rest, dtype)
        jp = jnp.asarray(pos)
        j_raw = jmcmc.block_context(jr, jp, HB)
        if dtype == "float64":
            # the JAX encoder casts its modes to float32; at float64 they
            # are the same integers
            jmodes = jnp.asarray(np.stack(np.meshgrid(
                np.arange(-3, 4), np.arange(-3, 4), indexing="ij"),
                -1).reshape(-1, 2), jnp.float64)
            others = jmcmc.select_particles(jr, jp)
            phase = (np.pi / HB) * jnp.einsum("bnd,md->bnm", others, jmodes)
            j_four = jnp.concatenate([jnp.sum(jnp.cos(phase), -2),
                                      jnp.sum(jnp.sin(phase), -2)],
                                     -1) / (n - k)
        else:
            j_four = jmcmc.fourier_context(jr, jp, HB, m_max=M_MAX)
    t_raw = tmcmc.block_context(trest, tp, HB)
    t_four = tmcmc.fourier_context(trest, tp, HB, M_MAX)
    assert t_raw.shape == (b, tmcmc.context_dim(n, k))
    assert t_four.shape == (b, tmcmc.fourier_context_dim(M_MAX))
    np.testing.assert_allclose(np_(t_raw), np.asarray(j_raw), **tol)
    np.testing.assert_allclose(np_(t_four), np.asarray(j_four), **tol)
    # the Fourier context does not see the order of the rest
    shuffled = trest[:, torch.as_tensor(np.random.default_rng(6)
                                        .permutation(n - k))]
    np.testing.assert_allclose(
        np_(tmcmc.fourier_context(shuffled, tp, HB, M_MAX)), np_(t_four),
        rtol=0, atol=1e-12 if dtype == "float64" else 1e-5)
    assert tmcmc.context_dim(n, k) == jmcmc.context_dim(n, k)
    assert tmcmc.fourier_context_dim(M_MAX) == jmcmc.fourier_context_dim(
        M_MAX)


@pytest.mark.parametrize("n,k", [(4, 1), (4, 2), (5, 2)])
def test_random_blocks_draw_every_subset_equally(n, k):
    """A chi-square test of the blocks' k-subsets at a fixed seed (the
    0.1% critical value), and every row a permutation."""
    import itertools

    from scipy import stats

    draws = 40000
    perm = tmcmc.random_block_perm(draws, n, torch.Generator().manual_seed(7),
                                   "cpu")
    assert torch.equal(torch.sort(perm, dim=1).values,
                       torch.arange(n).expand(draws, n))
    subsets = {s: i for i, s in enumerate(itertools.combinations(range(n),
                                                                 k))}
    blocks = torch.sort(perm[:, :k], dim=1).values.tolist()
    counts = np.bincount([subsets[tuple(b)] for b in blocks],
                         minlength=len(subsets))
    chi2 = stats.chisquare(counts).statistic
    assert chi2 < stats.chi2.ppf(0.999, len(subsets) - 1), counts


# ----- the conditional net and flow ------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_context_glu_residual_net_matches_jax(k, batched):
    d_id = k
    kw = dict(in_features=2 * d_id, out_features=k * (3 * BINS + 1),
              hidden_features=HIDDEN, num_blocks=2, context_features=CTX)
    jnet = JResidualNet(use_norm=True, **kw)
    tnet = ResidualNet(**kw)
    tree = random_tree(jnet.init_params(jax.random.key(1)), 8 + k)
    assert set(tree["blocks"][0]) == {"l1", "l2", "ctx"}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(19, 2 * d_id))
    c = rng.normal(size=(19, CTX))
    with jax.enable_x64(True):
        want = jnet.apply(to_jax(tree), jnp.asarray(x),
                          context=jnp.asarray(c))
    got_tree = to_torch(tree, torch.float64)
    shapes = tree_map(lambda a: tuple(a.shape),
                      tnet.init_params(dtype=torch.float64, device="cpu"))
    assert shapes == tree_map(lambda a: tuple(np.shape(a)), tree)
    if batched:
        # the paired step's form: two nets stacked, the context broadcast
        two = tree_map(lambda a: torch.stack([a, 2.0 * a]), got_tree)
        tx = torch.as_tensor(x).expand(2, *x.shape)
        tc = torch.as_tensor(c).expand(2, *c.shape)
        got = tnet.apply(two, tx, tc)[0]
    else:
        got = tnet.apply(got_tree, torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_allclose(np_(got), np.asarray(want), **F64)


@pytest.mark.parametrize("k", [1, 2])
def test_conditional_flow_matches_jax_in_float64(k):
    rng = np.random.default_rng(10 + k)
    b = 23
    x = rng.uniform(-HB, HB, (b, 2 * k))
    z = rng.uniform(-HB, HB, (b, 2 * k))
    c = rng.normal(size=(b, CTX))
    jm, tree, tm = cond_flows(k, 20 + k)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        jc = jnp.asarray(c)
        paired = jm.layers[0].paired_forward_inverse(
            jp[0], jnp.asarray(z), jnp.asarray(x), context=jc)
        want = (*jm.forward_and_log_det(jp, jnp.asarray(z), context=jc),
                *jm.inverse_and_log_det(jp, jnp.asarray(x), context=jc),
                jm.log_prob(jp, jnp.asarray(x), context=jc),
                *paired[0], *paired[1])
    tz, tx, tc = map(torch.as_tensor, (z, x, c))
    with torch.no_grad():
        (pf, pld_f), (pi, pld_i) = tm.layers[0].paired_forward_inverse(
            tz, tx, tc)
        got = (*tm.forward_and_log_det(tz, tc),
               *tm.inverse_and_log_det(tx, tc), tm.log_prob(tx, tc),
               pf, pld_f, pi, pld_i)
        x_new, lq_new, lq_old = tm.push_forward_with_old(tz, tx, tc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), **F64)
    np.testing.assert_allclose(np_(x_new), np.asarray(want[0]), **F64)
    base = -2 * k * math.log(2 * HB)
    np.testing.assert_allclose(np_(lq_new), base - np.asarray(want[1]),
                               **F64)
    np.testing.assert_allclose(np_(lq_old), np.asarray(want[4]), **F64)
    # the context matters
    with torch.no_grad():
        assert float((tm.log_prob(tx, tc + 1.0) - got[4]).abs().max()) > 1e-3


@pytest.mark.parametrize("k", [1, 2])
def test_conditional_flow_matches_jax_in_float32(k):
    """log q and samples in float32 within 1e-5 (relative to 1 + |value|)
    of JAX's float64."""
    rng = np.random.default_rng(30 + k)
    b = 23
    x = rng.uniform(-HB, HB, (b, 2 * k))
    z = rng.uniform(-HB, HB, (b, 2 * k))
    c = rng.normal(size=(b, CTX))
    jm, tree, tm = cond_flows(k, 40 + k, K=2, dtype=torch.float32,
                              scale=0.2)
    with jax.enable_x64(True):
        jp = to_jax(tree)
        want = (jm.forward_and_log_det(jp, jnp.asarray(z),
                                       context=jnp.asarray(c))[0],
                jm.log_prob(jp, jnp.asarray(x), context=jnp.asarray(c)))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    with torch.no_grad():
        got = (tm.forward_and_log_det(f32(z), f32(c))[0],
               tm.log_prob(f32(x), f32(c)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.max(np.abs(np_(g) - w) / (1.0 + np.abs(w))) <= 1e-5


@pytest.mark.parametrize("K", [2, 3])
def test_paired_pass_matches_separate_passes(K):
    """R1: the paired loop and the separate sweeps give one proposal and
    the same log q's."""
    jm, tree, tm = cond_flows(1, 50 + K, K=K)
    rng = np.random.default_rng(60)
    x = torch.as_tensor(rng.uniform(-HB, HB, (31, 2)))
    c = torch.as_tensor(rng.normal(size=(31, CTX)))
    with torch.no_grad():
        z = tm.base_sample(31, torch.Generator().manual_seed(1))
        paired = tm.push_forward_with_old(z, x, c, paired=True)
        separate = tm.push_forward_with_old(z, x, c, paired=False)
        drawn = tm.sample_and_log_prob_with_old(
            31, x, torch.Generator().manual_seed(1), c)
    for p, s, d in zip(paired, separate, drawn):
        np.testing.assert_allclose(np_(p), np_(s), **F64)
        assert torch.equal(p, d)


def test_save_load_in_jax_and_shape_checks(tmp_path):
    jm, tree, tm = cond_flows(1, 70)
    assert (jax.tree_util.tree_structure(jm.init_params(jax.random.key(0)))
            == jax.tree_util.tree_structure(tree))
    path = str(tmp_path / "initial_model_blocked_conditional.pkl")
    tm.save(path)
    with jax.enable_x64(True):
        loaded = JConditionalFlow.load(jm, path)
    flat_a, struct_a = jax.tree_util.tree_flatten(tuple(tree))
    flat_b, struct_b = jax.tree_util.tree_flatten(loaded)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(b), a)
    other = build_conditional_circular_flow(
        1, 2, HB, context_features=CTX, K=3, hidden_units=HIDDEN,
        num_bins=BINS, device="cpu").double().load(path)
    for p, q in zip(tm.parameters(), other.parameters()):
        assert torch.equal(p, q)
    # a conditional tree does not go into a flow of another shape, or
    # into an unconditional flow, nor the other way round
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, build_conditional_circular_flow(
            1, 2, HB, context_features=CTX - 2, K=3, hidden_units=HIDDEN,
            num_bins=BINS, device="cpu"))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, build_circular_flow(
            1, 2, HB, K=3, hidden_units=HIDDEN, num_bins=BINS,
            device="cpu"))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(params_to_jax(build_circular_flow(
            1, 2, HB, K=3, hidden_units=HIDDEN, num_bins=BINS,
            device="cpu")), tm)


# ----- the blocked move ------------------------------------------------

def blocked_inputs(n, c, seed):
    """Chains near the wells of an N-particle system at rho = 0.03, each
    particle jittered, and a JAX chain state with per-chain keys."""
    rng = np.random.default_rng(seed)
    jspec = jops.SystemSpec.create(n, jops.Box.from_density(n, 0.03),
                                   **WELLS)
    tspec = tops.SystemSpec.create(n, tops.Box.from_density(n, 0.03),
                                   **WELLS)
    pos, _ = jmcmc.init_alternating_wells(c, n, 0.03)
    box = tspec.box.size_x
    pos = np.mod(np.asarray(pos) + rng.normal(0.0, 0.2, (c, n, 2)), box)
    pos = pos.astype(np.float32)
    jstate = jmcmc.init_chain_state(jspec, jnp.asarray(pos),
                                    jax.random.key(seed), 0.65)
    tstate = tmcmc.chain_state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if f != "key"}, 0, "cpu")
    return jspec, tspec, jstate, tstate


def jax_draws(jstate, model, c, n, k):
    """The permutation, base points and uniforms JAX's
    ``blocked_big_moves`` draws from ``state.key``, and its proposal
    key."""
    keys = jax.vmap(lambda kk: jax.random.split(kk, 3))(jstate.key)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys[:, 1])
    k_blocks = jax.random.fold_in(keys[0, 2], 0x51ED)
    k_prop = jax.random.fold_in(keys[0, 2], 0xB10C)
    perm = jnp.argsort(jax.random.uniform(k_blocks, (c, n)), axis=-1)
    z = model.base.sample(k_prop, c)
    return np.asarray(perm), np.asarray(z), np.asarray(u), k_prop


@pytest.mark.parametrize("n,k,seed", [(8, 1, 0), (8, 1, 1), (4, 2, 2)])
def test_apply_blocked_moves_matches_jax(n, k, seed):
    """JAX's ``blocked_big_moves`` and the port's ``apply_blocked_moves``
    on JAX's draws, float32.  The two flows' proposals part by float32
    rounding (about 1e-5), which the LJ repulsion of a proposal near
    contact amplifies in its energy (a force of 400 turns 1e-5 into
    4e-3), so the energies are held on the port's own proposals and the
    rest of the MH log-ratio, beta U_old + log q_old - log q_new, to 1e-5
    relative to the terms' magnitudes."""
    c = 96
    jspec, tspec, jstate, tstate = blocked_inputs(n, c, seed)
    hb = tspec.box.size_x / 2.0
    jm = j_build_cond(k, 2, hb, context_features=CTX, K=2,
                      hidden_units=HIDDEN, num_bins=BINS)
    tm = build_conditional_circular_flow(
        k, 2, hb, context_features=CTX, K=2, hidden_units=HIDDEN,
        num_bins=BINS, device="cpu")
    tree = random_tree(params_to_jax(tm), 80 + seed, 0.25)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    params_from_jax(tree, tm)
    j_ctx = lambda r, p: jmcmc.fourier_context(r, p, hb, m_max=M_MAX)  # noqa
    t_ctx = lambda r, p: tmcmc.fourier_context(r, p, hb, M_MAX)  # noqa
    jres = jmcmc.blocked_big_moves(jspec, 1.0, jstate, jm, jp, hb, k,
                                   context_fn=j_ctx)
    perm, z, u, k_prop = jax_draws(jstate, jm, c, n, k)
    tperm, tz, tu = map(torch.as_tensor, (perm, z.copy(), u.copy()))
    tres = tmcmc.apply_blocked_moves(tspec, 1.0, tstate, tperm, tz, tu, tm,
                                     hb, k, t_ctx)

    # each package's proposals on these draws
    sel, rest = map(jnp.asarray, onehots(perm, k))
    j_old = jmcmc.select_particles(sel, jstate.positions) - hb
    j_new, _, _ = jm.sample_and_log_prob_with_old(
        jp, k_prop, c, j_old.reshape(c, -1),
        context=j_ctx(rest, jstate.positions))
    j_props = jmcmc.scatter_block(sel, j_new.reshape(c, k, 2) + hb,
                                  jstate.positions)
    energy = jax.vmap(lambda q: jops.total_energy_virial(jspec, q)[0])
    np.testing.assert_array_equal(np.asarray(energy(j_props)),
                                  np.asarray(jres.proposal_energy))
    t_old = (tmcmc.select_particles(tperm[:, :k], tstate.positions)
             - hb).reshape(c, -1)
    with torch.no_grad():
        t_new = tm.push_forward_with_old(
            tz, t_old, t_ctx(tperm[:, k:], tstate.positions))[0]
    t_props = tmcmc.scatter_block(tperm[:, :k], t_new.reshape(c, k, 2) + hb,
                                  tstate.positions)
    np.testing.assert_allclose(np_(t_props), np.asarray(j_props), rtol=0,
                               atol=2e-5)
    t_e = np_(tres.proposal_energy)
    np.testing.assert_allclose(t_e, np.asarray(energy(jnp.asarray(
        np_(t_props)))), rtol=1e-5, atol=1e-4)

    j_ratio = np.asarray(jres.ratio_log)
    t_ratio = np_(tres.ratio_log)
    finite = np.isfinite(j_ratio)
    np.testing.assert_array_equal(np.isfinite(t_ratio), finite)
    # float32 rounds each ratio at the magnitude of its energies
    j_e = np.asarray(jres.proposal_energy, np.float64)
    j_rest = (j_ratio + j_e)[finite]
    t_rest = (t_ratio.astype(np.float64) + t_e)[finite]
    scale = np.abs(j_rest) + np.abs(j_e[finite])
    assert np.all(np.abs(t_rest - j_rest) <= 1e-5 * scale + 1e-4), (
        np.max(np.abs(t_rest - j_rest) / (scale + 10.0)))
    # the port's flags follow its ratios; JAX's agree wherever u is not
    # between the two packages' acceptance probabilities (R2)
    j_acc = np.asarray(jres.accepted)
    t_acc = np_(tres.accepted)
    np.testing.assert_array_equal(t_acc, u < np.exp(t_ratio))
    lo = np.minimum(np.exp(j_ratio), np.exp(t_ratio)) - NEAR_TIE
    hi = np.maximum(np.exp(j_ratio), np.exp(t_ratio)) + NEAR_TIE
    near = (lo <= u) & (u <= hi)
    np.testing.assert_array_equal(t_acc[~near], j_acc[~near])
    assert 0 < t_acc.sum() < c                   # the decisions are mixed
    keep = t_acc == j_acc
    np.testing.assert_allclose(np_(tres.state.positions)[keep],
                               np.asarray(jres.state.positions)[keep],
                               rtol=0, atol=2e-5)
    # an accepted chain takes its proposal's energy and virial (JAX's
    # engine on the port's proposals); a rejected one keeps its state
    # bit for bit
    acc = tres.accepted
    t_virial = jax.vmap(lambda q: jops.total_energy_virial(jspec, q)[1])(
        jnp.asarray(np_(t_props)))
    np.testing.assert_array_equal(np_(tres.state.energy)[t_acc], t_e[t_acc])
    np.testing.assert_allclose(np_(tres.state.virial)[t_acc],
                               np.asarray(t_virial)[t_acc], rtol=1e-5,
                               atol=1e-4)
    for f in ("positions", "energy", "virial"):
        assert torch.equal(getattr(tres.state, f)[~acc],
                           getattr(tstate, f)[~acc]), f
    np.testing.assert_array_equal(np_(tres.state.attempts),
                                  np.asarray(jres.state.attempts))
    np.testing.assert_array_equal(np_(tres.state.accepts), t_acc)
    # the unpaired form makes the same moves
    unpaired = tmcmc.apply_blocked_moves(tspec, 1.0, tstate, tperm, tz, tu,
                                         tm, hb, k, t_ctx, paired=False)
    np.testing.assert_allclose(np_(unpaired.ratio_log), t_ratio, rtol=1e-5,
                               atol=1e-4)


def test_overlapping_proposal_is_rejected_without_nan():
    n, c, k = 8, 16, 1
    _, tspec, _, tstate = blocked_inputs(n, c, 3)
    hb = tspec.box.size_x / 2.0
    tm = build_conditional_circular_flow(
        k, 2, hb, context_features=CTX, K=2, hidden_units=HIDDEN,
        num_bins=BINS, device="cpu")
    perm = torch.stack([torch.arange(n)] * c)       # particle 0 moves
    # onto particle 1 (identity flow: the proposal is z itself)
    z = (tstate.positions[:, 1] - hb).reshape(c, 2).clone()
    z[1::2] += 3.0                                   # half land elsewhere
    res = tmcmc.apply_blocked_moves(
        tspec, 1.0, tstate, perm, z, torch.zeros(c), tm, hb, k,
        lambda r, p: tmcmc.fourier_context(r, p, hb, M_MAX))
    assert torch.isinf(res.proposal_energy[0::2]).all()
    assert not res.accepted[0::2].any()
    assert torch.isneginf(res.ratio_log[0::2]).all()
    assert not torch.isnan(res.ratio_log).any()
    assert torch.equal(res.state.positions[0::2], tstate.positions[0::2])
    assert torch.isfinite(res.state.energy).all()
    assert torch.equal(res.state.accepts, res.accepted.to(torch.int32))
    assert torch.equal(res.state.attempts, tstate.attempts + 1)


def test_blocked_modules_import_no_jax_or_flowstate_tpu():
    code = ("import sys, flowstate_tpu_torch.flows.models, "
            "flowstate_tpu_torch.mcmc.blocked, "
            "flowstate_tpu_torch.training.blocked, "
            "flowstate_tpu_torch.tools.blocked_recipe; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flowstate_tpu', 'matplotlib'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
