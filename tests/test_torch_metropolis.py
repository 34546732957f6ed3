"""The port's Metropolis engine and move-kernel module against the JAX package.

The plain engine (``flowstate_tpu_torch.mcmc.metropolis``) is the move
kernel's plain version and its oracle, so it is held here against the JAX
engine move for move: the same numpy random tables go through JAX
``_apply_move`` (scanned) and through the port.  Near-tie rule: an accept
decision may differ only where ``|exp(-beta dE) - u| < 1e-5``; a chain
whose first disagreement is such a tie leaves the comparison (its two
trajectories then part ways legitimately), any other disagreement fails.

The Pallas kernel itself runs here in interpret mode, whose on-chip PRNG
returns zero bits; all-zero tables reproduce that stream in the port.  The
CUDA kernel runs only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.mcmc.metropolis import _apply_move
from flowstate_tpu.mcmc.pallas_metropolis import run_moves_pallas
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS

torch.set_num_threads(1)

NEAR_TIE = 1e-5
POS_ATOL = 1e-5


def _specs(n, v0=(-10.0, -10.5), rho=0.03):
    kw = dict(num_wells=2, V0_list=v0, r0=1.2, k=15.0)
    return (jops.SystemSpec.create(n, jops.Box.from_density(n, rho, 1.0), **kw),
            tops.SystemSpec.create(n, tops.Box.from_density(n, rho, 1.0), **kw))


def _states(jspec, n, c, seed, max_disp=0.65):
    pos, _ = jmcmc.init_alternating_wells(c, n, 0.03)
    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos), jax.random.key(seed),
                                max_disp)
    ts = tmcmc.chain_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}, seed, "cpu")
    return js, ts


def _tables(n, c, t, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, size=(c, t)).astype(np.int32),
            rng.random((c, t, 2), dtype=np.float32),
            rng.random((c, t), dtype=np.float32))


def _torch_tables(tables):
    return tuple(torch.as_tensor(a) for a in tables)


def _jax_scan(jspec, js, tables):
    """JAX ``_apply_move`` over the tables; returns the final state and the
    per-move accept decisions (C, T)."""
    def one_chain(s, p, d, u):
        def body(s, xs):
            s2 = _apply_move(jspec, 1.0, s, *xs)
            return s2, s2.accepts > s.accepts
        return jax.lax.scan(body, s, (p, d, u))

    return jax.jit(jax.vmap(one_chain))(js, *(jnp.asarray(a) for a in tables))


def _split_chains(ref_accepts, margins):
    """Chains whose decisions ever differ from the reference; each must
    first differ at a near tie (judged by the port's margin)."""
    differ = np.asarray(ref_accepts) != (margins > 0)
    split = differ.any(axis=1)
    first = differ.argmax(axis=1)
    ties = np.abs(margins[split, first[split]])
    assert np.all(ties < NEAR_TIE), ties
    assert split.sum() <= max(1, len(split) // 100)
    return split


def _assert_same_state(js, ts, keep, e_atol, virial=True):
    np.testing.assert_allclose(ts.positions.numpy()[keep],
                               np.asarray(js.positions)[keep], atol=POS_ATOL)
    np.testing.assert_allclose(ts.energy.numpy()[keep],
                               np.asarray(js.energy)[keep], atol=e_atol)
    if virial:
        np.testing.assert_allclose(ts.virial.numpy()[keep],
                                   np.asarray(js.virial)[keep], atol=e_atol)
    np.testing.assert_array_equal(ts.accepts.numpy()[keep],
                                  np.asarray(js.accepts)[keep])
    np.testing.assert_array_equal(ts.attempts.numpy(), np.asarray(js.attempts))


@pytest.mark.parametrize("n", [3, 12])
def test_plain_engine_matches_jax_apply_move_pathwise(n):
    jspec, tspec = _specs(n)
    c, t = 64, 200
    js, ts = _states(jspec, n, c, seed=n)
    tables = _tables(n, c, t, seed=100 + n)
    js_out, j_acc = _jax_scan(jspec, js, tables)
    margins = torch.empty((c, t))
    ts_out = tmcmc.run_moves(tspec, 1.0, ts, t, _torch_tables(tables), margins)
    keep = ~_split_chains(j_acc, margins.numpy())
    _assert_same_state(js_out, ts_out, keep, e_atol=1e-4)
    assert ts_out.calls == ts.calls + 1


@pytest.mark.parametrize("n,c,moves", [(3, 100, 100), (12, 64, 30)])
def test_plain_version_matches_pallas_interpret_with_zero_tables(n, c, moves):
    """Interpret mode's zero bits: particle 0, displacement -0.5 max_disp,
    u = 0 — the same as all-zero tables in the port."""
    jspec, tspec = _specs(n)
    js, ts = _states(jspec, n, c, seed=5)
    j_out = run_moves_pallas(jspec, 1.0, js, moves, seed=3, interpret=True)
    zeros = (torch.zeros((c, moves), dtype=torch.int32),
             torch.zeros((c, moves, 2)), torch.zeros((c, moves)))
    t_out = cm.run_moves_plain(tspec, 1.0, ts, moves, zeros)
    keep = np.ones(c, dtype=bool)
    _assert_same_state(j_out, t_out, keep, e_atol=1e-3, virial=False)
    assert np.all(np.isnan(np.asarray(j_out.virial)))
    assert torch.isnan(t_out.virial).all()


def test_adjust_init_resync_and_state_transfer_match_jax():
    jspec, tspec = _specs(3)
    c = 16
    pos, _ = jmcmc.init_alternating_wells(c, 3, 0.03)
    js = jmcmc.init_chain_state(jspec, jnp.asarray(pos), jax.random.key(0), 0.65)
    ts = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), seed=0,
                                initial_max_displacement=0.65)
    for f in TENSOR_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6)
        assert getattr(ts, f).dtype == {"int32": torch.int32,
                                        "float32": torch.float32}[
            str(np.asarray(getattr(js, f)).dtype)]
    # counters with some accepts, then adapt: clamps on both sides and no-op
    rng = np.random.default_rng(3)
    att = np.full(c, 100, np.int32)
    att[:2] = 0                                  # no attempts: unchanged
    acc = np.minimum(rng.integers(0, 101, c), att).astype(np.int32)
    js = js._replace(attempts=jnp.asarray(att), accepts=jnp.asarray(acc))
    ts = tmcmc.chain_state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}, 0, "cpu")
    ja = jmcmc.adjust_displacement(js)
    ta = tmcmc.adjust_displacement(ts)
    for f in ("max_disp", "prev_attempts", "prev_accepts"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(ja, f)), rtol=1e-6)
    # resync after a perturbation of the cached totals
    js = js._replace(energy=js.energy + 1.0, virial=js.virial * jnp.nan)
    ts = ts.replace(energy=ts.energy + 1.0,
                    virial=ts.virial * float("nan"))
    jr = jmcmc.resync_energy(jspec, js)
    tr = tmcmc.resync_energy(tspec, ts)
    np.testing.assert_allclose(tr.energy.numpy(), jr.energy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.virial.numpy(), jr.virial, rtol=1e-5, atol=1e-5)


def test_batched_energy_virial_chunks_match_unchunked():
    _, tspec = _specs(12)
    pos, _ = tmcmc.init_alternating_wells(10, 12, 0.03)
    pos = torch.as_tensor(pos, dtype=torch.float32)
    from flowstate_tpu_torch.mcmc.state import batched_energy_virial

    e_full, v_full = batched_energy_virial(tspec, pos)
    e_chunk, v_chunk = batched_energy_virial(tspec, pos, chunk_elems=3 * 288)
    torch.testing.assert_close(e_chunk, e_full)
    torch.testing.assert_close(v_chunk, v_full)


def test_single_particle_boltzmann_free_energy_plain_engine():
    """ΔF = ln(P_B/P_A) sampled by the plain engine against quadrature
    (the exact-physics gate of tests/test_mcmc.py)."""
    spec = tops.SystemSpec.create(1, tops.Box.from_density(1, 0.01, 1.0),
                                  num_wells=2, V0_list=(-2.0, -2.5), r0=1.2,
                                  k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], -1),
                          dtype=torch.float32)
    v = tops.double_well_potential(pts, lx, ly, V0_list=list(spec.V0_list),
                                   r0=spec.r0, k=spec.k).numpy().reshape(g, g)
    w = np.exp(-v)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    in_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact = np.log(w[in_b].sum() / w[in_a].sum())

    c = 256
    pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (c, 1, 1))
    pos0[c // 2:, :, 0] = 3 * lx / 4
    s = tmcmc.init_chain_state(spec, torch.as_tensor(pos0), 7, 1.5)
    s = tmcmc.run_moves(spec, 1.0, s, 300)
    s, obs = tmcmc.run_production_with(
        spec, 1.0, s, 600, 5, lambda st, m: tmcmc.run_moves(spec, 1.0, st, m))
    xy = obs.positions.reshape(-1, 2).numpy()
    sa = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    sb = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    sampled = np.log(sb.sum() / sa.sum())
    assert abs(sampled - exact) < 0.12, (sampled, exact)


def test_plain_engine_is_reproducible_and_advances_its_stream():
    _, tspec = _specs(3)
    pos, _ = tmcmc.init_alternating_wells(8, 3, 0.03)
    s = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 11, 0.65)
    a = tmcmc.run_moves(tspec, 1.0, s, 300)
    b = tmcmc.run_moves(tspec, 1.0, s, 300)
    torch.testing.assert_close(a.positions, b.positions, rtol=0, atol=0)
    c = tmcmc.run_moves(tspec, 1.0, a, 300)   # next segment: fresh draws
    assert a.calls == 1 and c.calls == 2
    assert not torch.equal(a.positions,
                           tmcmc.run_moves(tspec, 1.0, s.replace(calls=1),
                                           300).positions)
    assert not torch.equal(a.positions,        # another seed, same calls
                           tmcmc.run_moves(tspec, 1.0, s.replace(seed=12),
                                           300).positions)


def test_auto_dispatch_on_cpu_and_kernel_refuses_cpu_tensors():
    _, tspec = _specs(3)
    pos, _ = tmcmc.init_alternating_wells(8, 3, 0.03)
    s = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 1, 0.65)
    before = cm.LAUNCHES
    out = cm.run_moves_auto(tspec, 1.0, s, 20)
    assert cm.LAUNCHES == before
    assert torch.all(out.attempts == 20)
    assert torch.isnan(out.virial).all()        # the kernel's contract
    with pytest.raises(ValueError, match="CUDA"):
        cm.run_moves_kernel(tspec, 1.0, s, 20)
    assert cm.LAUNCHES == before
    out, obs = cm.run_production_kernel(tspec, 1.0, s, 3, 10)
    assert obs.positions.shape == (8, 3, 3, 2)
    np.testing.assert_array_equal(obs.cycle[0].numpy(), [10, 20, 30])
    assert torch.isfinite(obs.pressure).all()   # resynced before sampling
    assert cm.LAUNCHES == before


def test_table_validation():
    _, tspec = _specs(3)
    pos, _ = tmcmc.init_alternating_wells(4, 3, 0.03)
    s = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 1, 0.65)
    good = (torch.zeros((4, 5), dtype=torch.int32), torch.zeros((4, 5, 2)),
            torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="int32"):
        cm.run_moves_plain(tspec, 1.0, s, 5, (good[0].long(),) + good[1:])
    with pytest.raises(ValueError, match="shape"):
        cm.run_moves_plain(tspec, 1.0, s, 6, good)
    with pytest.raises(ValueError, match="outside"):
        cm.run_moves_plain(tspec, 1.0, s, 5, (good[0] + 3,) + good[1:])
