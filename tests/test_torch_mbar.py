"""The port's MBAR (``analysis/mbar.py``) against the JAX package.

All four functions on the same reduced potentials, made from a numpy
seed, in float64 (JAX inside ``jax.enable_x64``): f_k, the log-weights,
an expectation and the PT well ΔF agree to 1e-10 absolute.  The tempering
driver's pooled analysis (``experiments.tempering.mbar_well_delta_f``:
thinning, the cold state's weights, the particle-level ΔF and its 5-block
SEM, the sector ΔF) agrees to 1e-10 with the JAX driver's lines
(``flowstate_tpu/experiments/tempering.py:204-250``) written out here
with the JAX functions, on the same (T, R, W) records.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flowstate_tpu.analysis import mbar as jmbar
from flowstate_tpu_torch.analysis import mbar
from flowstate_tpu_torch.experiments.tempering import mbar_well_delta_f

ATOL = 1e-10


def ladder_samples(seed, r=4, m=3000):
    """Energies of a 1-D harmonic well sampled at R temperatures, and
    their reduced potentials in every state."""
    rng = np.random.default_rng(seed)
    betas = 1.0 / np.geomspace(1.0, 6.0, r)
    x = np.concatenate([rng.normal(0.0, 1.0 / np.sqrt(b), m) for b in betas])
    energies = 0.5 * x ** 2 - 3.0
    return betas, energies.reshape(r, m), x


def test_four_functions_equal_jax_in_float64():
    betas, energies, x = ladder_samples(0)
    r, m = energies.shape
    u_kn = betas[:, None] * energies.reshape(-1)[None, :]
    n_k = np.full(r, m)
    f = mbar.mbar_free_energies(u_kn, n_k)
    assert f.dtype == torch.float64 and float(f[0]) == 0.0
    lw = mbar.mbar_log_weights(u_kn, n_k, f, 2)
    ex = mbar.mbar_expectation(u_kn, n_k, f, x ** 2, 1)
    all_a, all_b = x < -0.5, x > 0.7
    df, fk = mbar.pt_well_delta_f(energies, betas, all_a, all_b,
                                  num_iters=300)
    with jax.enable_x64(True):
        jf = jmbar.mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k))
        jlw = jmbar.mbar_log_weights(jnp.asarray(u_kn), jnp.asarray(n_k),
                                     jf, 2)
        jex = jmbar.mbar_expectation(jnp.asarray(u_kn), jnp.asarray(n_k),
                                     jf, jnp.asarray(x ** 2), 1)
        jdf, jfk = jmbar.pt_well_delta_f(
            jnp.asarray(energies), jnp.asarray(betas), jnp.asarray(all_a),
            jnp.asarray(all_b), num_iters=300)
        jf, jlw, jex, jfk = (np.asarray(a) for a in (jf, jlw, jex, jfk))
    np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lw.numpy(), jlw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(ex), float(jex), rtol=0, atol=ATOL)
    np.testing.assert_allclose(fk.numpy(), jfk, rtol=0, atol=ATOL)
    assert abs(df - jdf) < ATOL
    # the harmonic well's exact f_k: -ln(Z_k / Z_0), Z = sqrt(2 pi / b) e^3b
    exact = -(0.5 * np.log(betas[0] / betas) + 3.0 * (betas - betas[0]))
    np.testing.assert_allclose(f.numpy(), exact, atol=0.05)
    np.testing.assert_allclose(float(torch.exp(lw).sum()), 1.0, rtol=1e-12)


def jax_driver_analysis(betas, na, nb, e_all, n, burn):
    """The JAX driver's MBAR lines on (T, R, W) records."""
    t_rounds, r, w = e_all.shape
    all_a, all_b = na == n, nb == n
    stride = max(1, (t_rounds - burn) * r * w // 500_000)
    na_t, nb_t, e_t = (a[burn:][::stride] for a in (na, nb, e_all))
    all_a_t, all_b_t = all_a[burn:][::stride], all_b[burn:][::stride]
    e_pool = e_t.transpose(1, 0, 2).reshape(r, -1)
    m = e_pool.shape[1]
    with jax.enable_x64(True):
        u_kn = (jnp.asarray(betas, jnp.float64)[:, None]
                * jnp.asarray(e_pool.reshape(-1), jnp.float64)[None, :])
        f_k = jmbar.mbar_free_energies(u_kn, jnp.full((r,), m),
                                       num_iters=500)
        log_w = np.asarray(jmbar.mbar_log_weights(u_kn, jnp.full((r,), m),
                                                  f_k, 0))
    wgt = np.exp(log_w - log_w.max())
    wgt /= wgt.sum()
    na_pool = na_t.transpose(1, 0, 2).reshape(-1)
    nb_pool = nb_t.transpose(1, 0, 2).reshape(-1)
    ratio = lambda wt, a, b: float(np.log(  # noqa: E731
        max((wt * a).sum(), 1e-300) / max((wt * b).sum(), 1e-300)))
    blocks = []
    idx = np.arange(r * m).reshape(r, -1, w)
    t_post = idx.shape[1]
    for b in range(5):
        sel = np.zeros(r * m, bool)
        sel[idx[:, b * t_post // 5:(b + 1) * t_post // 5].reshape(-1)] = True
        blocks.append(ratio(np.where(sel, wgt, 0.0), nb_pool, na_pool))
    return {"df_particle_mbar": ratio(wgt, nb_pool, na_pool),
            "df_particle_mbar_sem": float(np.std(blocks) / np.sqrt(5)),
            "df_sector_mbar": ratio(
                wgt, all_b_t.transpose(1, 0, 2).reshape(-1),
                all_a_t.transpose(1, 0, 2).reshape(-1)),
            "f_k": np.asarray(f_k)}


def test_driver_pooled_analysis_equals_jax_driver():
    rng = np.random.default_rng(7)
    t, r, w, n = 90, 4, 6, 3
    betas = (1.0 / np.geomspace(1.0, 10.0, r)).astype(np.float32)
    # energies that fall with the occupancy of well B, so the weights
    # tilt towards it at the cold state
    nb = rng.integers(0, n + 1, (t, r, w)).astype(np.int16)
    na = (rng.integers(0, n + 1, (t, r, w)) * (nb < n)).astype(np.int16)
    na = np.minimum(na, n - nb).astype(np.int16)
    e_all = (-10.0 * (na + nb) - 0.5 * nb
             + rng.normal(0, 1.0, (t, r, w)) / betas[None, :, None]
             ).astype(np.float32)
    for burn, max_pool in ((30, 500_000), (10, 200)):
        mine = mbar_well_delta_f(torch.as_tensor(betas), na, nb, e_all, n,
                                 burn, max_pool)
        if max_pool == 500_000:
            ref = jax_driver_analysis(betas, na, nb, e_all, n, burn)
            for k in ("df_particle_mbar", "df_particle_mbar_sem",
                      "df_sector_mbar"):
                assert abs(mine[k] - ref[k]) < ATOL, k
            np.testing.assert_allclose(mine["f_k"], ref["f_k"], rtol=0,
                                       atol=ATOL)
            assert mine["stride"] == 1 and mine["pooled"] == r * (t - burn) * w
        else:   # thinned: every stride-th post-burn round
            assert mine["stride"] == (t - burn) * r * w // max_pool
            assert mine["pooled"] == r * w * len(range(burn, t,
                                                       mine["stride"]))
        assert all(np.isfinite([mine["df_particle_mbar"],
                                mine["df_particle_mbar_sem"]]))
