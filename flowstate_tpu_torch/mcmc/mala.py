"""MALA: gradient-informed whole-configuration moves.

Port of ``flowstate_tpu/mcmc/mala.py``.  Metropolis-adjusted Langevin
proposes ``y = x - tau * beta * grad U(x) + sqrt(2 tau) xi`` for all
particles at once and corrects with the Gaussian proposal ratio, so the
stationary distribution is exactly the Boltzmann measure.

* The gradient is ``torch.autograd.grad`` of the plain
  ``ops/pair_energy.py::total_energy_virial`` summed over chains (the
  chains are independent, so each chain's rows are its own gradient);
  non-finite entries (an overlapping configuration) are zeroed, so the
  drift never makes a NaN position and the energy rejects the move.  The
  pair-energy kernel has no backward pass, in either package.
* The proposal's energy and virial go through
  ``state.batched_energy_virial``: the pair-energy kernel on the card,
  its plain version on the CPU.  An overlapping proposal has U = +inf, so
  ``exp(log_alpha) = 0`` and it is rejected.
* The per-chain step size tau lives in ``ChainState.max_disp`` and adapts
  by the displacement engine's rule towards 0.574, the MALA optimum.
* Proposals wrap into the box; the proposal density uses the minimum
  image displacement, the dominant term of the wrapped Gaussian.

Everything is batched over the (C, ...) chains.  ``run_mala`` draws its
randoms from ``metropolis.generator_for(state)`` (seeded by ``(seed,
calls)``) and advances ``calls``; ``mala_apply`` takes them drawn.
"""

from __future__ import annotations

import torch

from flowstate_tpu_torch.mcmc.metropolis import (
    RNG_CHUNK, adjust_displacement, generator_for,
)
from flowstate_tpu_torch.mcmc.state import ChainState, batched_energy_virial
from flowstate_tpu_torch.ops.box import min_image, wrap_pbc
from flowstate_tpu_torch.ops.pair_energy import SystemSpec, total_energy_virial

MALA_TARGET_ACCEPTANCE = 0.574  # the MALA-optimal rate


def potential_gradient(spec: SystemSpec, positions: torch.Tensor
                       ) -> torch.Tensor:
    """grad_x U(x) of every (N, 2) configuration of a (C, N, 2) batch, in
    its dtype; non-finite entries zeroed."""
    with torch.enable_grad():
        x = positions.detach().requires_grad_(True)
        energy, _ = total_energy_virial(spec, x)
        (g,) = torch.autograd.grad(energy.sum(), x)
    return torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def _accept(state: ChainState, accept: torch.Tensor, positions: torch.Tensor,
            energy: torch.Tensor, virial: torch.Tensor) -> ChainState:
    return state.replace(
        positions=torch.where(accept[:, None, None], positions,
                              state.positions),
        energy=torch.where(accept, energy, state.energy),
        virial=torch.where(accept, virial, state.virial),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.to(state.accepts.dtype),
    )


def mala_apply(spec: SystemSpec, beta: float, state: ChainState,
               noise: torch.Tensor, u: torch.Tensor) -> ChainState:
    """One MALA update of every chain given drawn randoms: ``noise``
    (C, N, 2) standard normals, ``u`` (C,) acceptance uniforms."""
    x = state.positions
    tau = state.max_disp[:, None, None]
    drift_x = -tau * beta * potential_gradient(spec, x)
    y = wrap_pbc(x + drift_x + torch.sqrt(2.0 * tau) * noise, spec.box)

    e_new, vir_new = batched_energy_virial(spec, y)
    drift_y = -tau * beta * potential_gradient(spec, y)

    # minimum-image displacements: the dominant wrapped-Gaussian term
    d_fwd = min_image(y - (x + drift_x), spec.box)
    d_rev = min_image(x - (y + drift_y), spec.box)
    four_tau = 4.0 * state.max_disp
    log_q_fwd = -torch.sum(d_fwd * d_fwd, dim=(1, 2)) / four_tau
    log_q_rev = -torch.sum(d_rev * d_rev, dim=(1, 2)) / four_tau

    # an inf proposal energy gives log_alpha = -inf -> exp 0 -> reject
    log_alpha = -beta * (e_new - state.energy) + log_q_rev - log_q_fwd
    accept = u < torch.exp(torch.clamp(log_alpha, max=0.0))
    return _accept(state, accept, y, e_new.to(state.energy.dtype),
                   vir_new.to(state.virial.dtype))


def run_mala(spec: SystemSpec, beta: float, state: ChainState,
             num_moves: int) -> ChainState:
    """``num_moves`` sequential MALA updates of every chain, the randoms
    drawn ``RNG_CHUNK`` moves at a time from ``generator_for(state)``;
    advances ``calls``.  The draw covers every chain of the run and a
    shard keeps its ``global_rows()``, so a sharded run equals the
    unsharded one; MALA has no kernel, so each rank pays for the whole
    draw (noise of (moves, all chains, N, 2))."""
    c, n = state.num_global_chains, state.positions.shape[1]
    rows = state.global_rows()
    g = generator_for(state)
    for start in range(0, num_moves, RNG_CHUNK):
        m = min(RNG_CHUNK, num_moves - start)
        noise = torch.randn((m, c, n, 2), generator=g, device=state.device,
                            dtype=state.positions.dtype)[:, rows]
        u = torch.rand((m, c), generator=g, device=state.device,
                       dtype=state.energy.dtype)[:, rows]
        for i in range(m):
            state = mala_apply(spec, beta, state, noise[i], u[i])
    return state.replace(calls=state.calls + 1)


def adjust_tau(state: ChainState,
               target_acceptance: float = MALA_TARGET_ACCEPTANCE
               ) -> ChainState:
    """Adapt the per-chain tau (in ``max_disp``) towards the MALA optimum
    by the displacement engine's clamped multiplicative rule."""
    return adjust_displacement(state, target_acceptance)


def run_mala_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                           num_steps: int, adjusting_frequency: int,
                           target_acceptance: float = MALA_TARGET_ACCEPTANCE
                           ) -> ChainState:
    """MALA moves with tau adapted every ``adjusting_frequency`` moves
    (equilibration only: production keeps detailed balance)."""
    num_blocks, remainder = divmod(num_steps, adjusting_frequency)
    for _ in range(num_blocks):
        state = adjust_tau(run_mala(spec, beta, state, adjusting_frequency),
                           target_acceptance)
    if remainder > 0:
        state = run_mala(spec, beta, state, remainder)
    return state
