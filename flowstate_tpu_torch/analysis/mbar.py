"""MBAR: the multistate Bennett acceptance ratio free-energy estimator.

Port of ``flowstate_tpu/analysis/mbar.py``.  MBAR (Shirts & Chodera 2008)
pools the samples of every thermodynamic state (every replica of a
parallel-tempering ladder, ``mcmc/tempering.py``) into one estimate of
the state free energies and of expectations at any state.  The
self-consistent iteration

    f_k = -logsumexp_n [ -u_k(x_n) - logsumexp_l (log N_l + f_l - u_l(x_n)) ]

runs a fixed number of iterations (500 by default, as the JAX
``lax.scan``), in float64 throughout, on the device of ``u_kn``: on the
card the whole pool stays there.

Conventions: ``u_kn[k, n]`` is the reduced potential beta_k * U(x_n) of
pooled sample n in state k; ``n_k[k]`` is how many of the pooled samples
came from state k; the returned ``f_k`` has f_0 = 0 and
f_k = -ln(Z_k / Z_0).  Arrays may be numpy or tensors; results are float64
tensors on ``u_kn``'s device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _log_denominator(u_kn: torch.Tensor, log_n: torch.Tensor,
                     f_k: torch.Tensor) -> torch.Tensor:
    """(N,) log of the mixture denominator at every pooled sample."""
    return torch.logsumexp(log_n[:, None] + f_k[:, None] - u_kn, dim=0)


def mbar_free_energies(u_kn, n_k, num_iters: int = 500) -> torch.Tensor:
    """Solve the MBAR equations; returns f_k with f[0] = 0."""
    u_kn = _f64(u_kn)
    log_n = torch.log(_f64(n_k, u_kn.device))
    f = torch.zeros(u_kn.shape[0], dtype=torch.float64, device=u_kn.device)
    for _ in range(num_iters):
        log_denom = _log_denominator(u_kn, log_n, f)
        f_new = -torch.logsumexp(-u_kn - log_denom[None, :], dim=1)
        f = f_new - f_new[0]
    return f


def mbar_log_weights(u_kn, n_k, f_k, target_k: int) -> torch.Tensor:
    """(N,) normalized log-weights of the pooled samples at state
    ``target_k``."""
    u_kn = _f64(u_kn)
    log_n = torch.log(_f64(n_k, u_kn.device))
    log_denom = _log_denominator(u_kn, log_n, _f64(f_k, u_kn.device))
    log_w = -u_kn[target_k] - log_denom
    return log_w - torch.logsumexp(log_w, dim=0)


def mbar_expectation(u_kn, n_k, f_k, observable_n,
                     target_k: int) -> torch.Tensor:
    """<A>_target over the pooled samples, reweighted to ``target_k``."""
    log_w = mbar_log_weights(u_kn, n_k, f_k, target_k)
    return torch.sum(torch.exp(log_w) * _f64(observable_n, log_w.device))


def pt_well_delta_f(energies, betas, all_a_n, all_b_n,
                    num_iters: int = 500) -> Tuple[float, torch.Tensor]:
    """ΔF = ln P(all B)/P(all A) at the cold state from every replica.

    Args:
      energies: (R, M) potential energies of every replica's M recorded
        samples (``ReplicaExchangeResult`` with ``record='all'``).
      betas: (R,) the ladder.
      all_a_n / all_b_n: (R*M,) bool indicators of the pooled samples
        (replica 0's samples first).
    Returns (delta_f, f_k).
    """
    e = _f64(energies)
    r, m = e.shape
    u_kn = _f64(betas, e.device)[:, None] * e.reshape(-1)[None, :]
    n_k = torch.full((r,), float(m), dtype=torch.float64, device=e.device)
    f_k = mbar_free_energies(u_kn, n_k, num_iters)
    log_w = mbar_log_weights(u_kn, n_k, f_k, 0)
    minus_inf = torch.full_like(log_w, float("-inf"))
    all_a = torch.as_tensor(all_a_n, device=e.device).reshape(-1).bool()
    all_b = torch.as_tensor(all_b_n, device=e.device).reshape(-1).bool()
    log_pb = torch.logsumexp(torch.where(all_b, log_w, minus_inf), dim=0)
    log_pa = torch.logsumexp(torch.where(all_a, log_w, minus_inf), dim=0)
    return float(log_pb - log_pa), f_k
