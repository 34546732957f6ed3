"""HMC: multi-step Hamiltonian whole-configuration moves.

Port of ``flowstate_tpu/mcmc/hmc.py``.  Draw momenta ``p ~ N(0, I)``,
integrate ``H(x, p) = beta U(x) + |p|^2 / 2`` for ``num_leapfrog`` leapfrog
steps of size ``eps`` and accept with ``exp(-dH)``.  The splitting is the
JAX one: a half kick, then ``num_leapfrog`` (drift, full kick), then half
of the last kick undone.

* The gradient is ``mala.potential_gradient`` (autograd of the plain
  energy, non-finite entries zeroed); the end point's energy and virial go
  through ``state.batched_energy_virial`` (the pair-energy kernel on the
  card).  A trajectory that ends in the hard core has U = +inf and is
  rejected.
* The per-chain ``eps`` lives in ``ChainState.max_disp`` and adapts
  towards 0.65, the HMC optimum.  ``attempts`` counts trajectories.
* Positions wrap after every drift; on the torus the wrap commutes with
  the dynamics, so the integrator stays volume-preserving and reversible.

Batched over the (C, ...) chains.  ``run_hmc`` draws its randoms from
``metropolis.generator_for(state)`` and advances ``calls``;
``hmc_apply`` takes them drawn.
"""

from __future__ import annotations

from typing import Optional

import torch

from flowstate_tpu_torch.mcmc.mala import _accept, potential_gradient
from flowstate_tpu_torch.mcmc.metropolis import (
    RNG_CHUNK, adjust_displacement, generator_for,
)
from flowstate_tpu_torch.mcmc.state import ChainState, batched_energy_virial
from flowstate_tpu_torch.ops.box import wrap_pbc
from flowstate_tpu_torch.ops.pair_energy import SystemSpec

HMC_TARGET_ACCEPTANCE = 0.65  # optimal HMC acceptance (Beskos et al. 2013)
DEFAULT_NUM_LEAPFROG = 10


def hmc_apply(spec: SystemSpec, beta: float, state: ChainState,
              p0: torch.Tensor, u: torch.Tensor,
              num_leapfrog: int = DEFAULT_NUM_LEAPFROG) -> ChainState:
    """One HMC trajectory and decision of every chain given drawn randoms:
    ``p0`` (C, N, 2) standard-normal momenta, ``u`` (C,) uniforms."""
    if num_leapfrog < 1:
        raise ValueError(f"num_leapfrog must be >= 1, got {num_leapfrog}")
    x0 = state.positions
    eps = state.max_disp[:, None, None]
    p = p0 - 0.5 * eps * beta * potential_gradient(spec, x0)
    x = x0
    for _ in range(num_leapfrog):
        x = wrap_pbc(x + eps * p, spec.box)
        g = potential_gradient(spec, x)
        p = p - eps * beta * g
    p = p + 0.5 * eps * beta * g

    e_new, vir_new = batched_energy_virial(spec, x)
    # dH = beta dU + dK; an inf proposal energy gives -inf -> exp 0 -> reject
    d_kinetic = 0.5 * (torch.sum(p * p, dim=(1, 2))
                       - torch.sum(p0 * p0, dim=(1, 2)))
    log_alpha = -beta * (e_new - state.energy) - d_kinetic
    accept = u < torch.exp(torch.clamp(log_alpha, max=0.0))
    return _accept(state, accept, x, e_new.to(state.energy.dtype),
                   vir_new.to(state.virial.dtype))


def hmc_move(spec: SystemSpec, beta: float, state: ChainState,
             num_leapfrog: int = DEFAULT_NUM_LEAPFROG,
             p0: Optional[torch.Tensor] = None,
             u: Optional[torch.Tensor] = None) -> ChainState:
    """One HMC trajectory and decision of every chain (JAX's ``hmc_move``
    is the same step for one chain): ``hmc_apply`` on the momenta ``p0``
    and uniforms ``u`` when given, else ``run_hmc`` of one trajectory.
    Advances ``calls``."""
    if p0 is None and u is None:
        return run_hmc(spec, beta, state, 1, num_leapfrog)
    if p0 is None or u is None:
        raise ValueError("give both p0 and u, or neither")
    return hmc_apply(spec, beta, state, p0, u, num_leapfrog).replace(
        calls=state.calls + 1)


def run_hmc(spec: SystemSpec, beta: float, state: ChainState, num_moves: int,
            num_leapfrog: int = DEFAULT_NUM_LEAPFROG) -> ChainState:
    """``num_moves`` sequential HMC trajectories of every chain, the
    randoms drawn ``RNG_CHUNK`` trajectories at a time from
    ``generator_for(state)``; advances ``calls``.  The draw covers every
    chain of the run and a shard keeps its ``global_rows()``, so a
    sharded run equals the unsharded one; HMC has no kernel, so each rank
    pays for the whole draw (momenta of (moves, all chains, N, 2))."""
    c, n = state.num_global_chains, state.positions.shape[1]
    rows = state.global_rows()
    g = generator_for(state)
    for start in range(0, num_moves, RNG_CHUNK):
        m = min(RNG_CHUNK, num_moves - start)
        p_tab = torch.randn((m, c, n, 2), generator=g, device=state.device,
                            dtype=state.positions.dtype)[:, rows]
        u = torch.rand((m, c), generator=g, device=state.device,
                       dtype=state.energy.dtype)[:, rows]
        for i in range(m):
            state = hmc_apply(spec, beta, state, p_tab[i], u[i],
                              num_leapfrog)
    return state.replace(calls=state.calls + 1)


def adjust_eps(state: ChainState,
               target_acceptance: float = HMC_TARGET_ACCEPTANCE
               ) -> ChainState:
    """Adapt the per-chain eps (in ``max_disp``) towards the HMC optimum
    by the displacement engine's clamped multiplicative rule."""
    return adjust_displacement(state, target_acceptance)


def run_hmc_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                          num_steps: int, adjusting_frequency: int,
                          num_leapfrog: int = DEFAULT_NUM_LEAPFROG,
                          target_acceptance: float = HMC_TARGET_ACCEPTANCE
                          ) -> ChainState:
    """HMC trajectories with eps adapted every ``adjusting_frequency``
    trajectories (equilibration only)."""
    num_blocks, remainder = divmod(num_steps, adjusting_frequency)
    for _ in range(num_blocks):
        state = adjust_eps(run_hmc(spec, beta, state, adjusting_frequency,
                                   num_leapfrog), target_acceptance)
    if remainder > 0:
        state = run_hmc(spec, beta, state, remainder, num_leapfrog)
    return state


# JAX's batched front ends vmap its one-chain functions over the chains;
# these are batched already, so they are the same functions.
run_hmc_batch = run_hmc
run_hmc_equilibration_batch = run_hmc_equilibration
