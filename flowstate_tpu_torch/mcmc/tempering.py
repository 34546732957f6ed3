"""Parallel tempering (replica exchange) on the batched Metropolis engine.

Port of ``flowstate_tpu/mcmc/tempering.py``.  R replicas of every walker
run at a ladder of temperatures, and adjacent-temperature replicas
periodically propose to exchange configurations with

    p_swap = min(1, exp((beta_i - beta_j) (E_i - E_j))),

which preserves the product distribution prod_r exp(-beta_r E) exactly.

Layout.  The JAX state has leading axes (R, W); the port's ``ChainState``
is (C, ...) with one ``seed`` and ``calls``, so the tempered state holds
C = R * W chains, replica-major: chain ``r * W + w`` is walker w at
temperature r.  ``replica_view`` gives the (R, W, ...) view of its tensors.
A round of local moves is one launch of the move kernel over all R * W
chains with each chain's own beta, ``chain_betas(betas, W)`` (the plain
engine on a CPU state).

Swaps (``swap_replicas``) are branchless, as in JAX: each replica computes
its partner under the alternating even/odd pairing, both members of a pair
read the uniform drawn at the lower index and so reach the same decision,
and the exchange is a ``torch.where`` over a gather along the replica
axis.  Positions, energy and virial swap; ``max_disp``, the counters and
the chain's Philox slot stay with the temperature.  The swap reads the
move kernel's tracked energy (no recompute per round); the kernel leaves
the virial NaN, and a NaN swaps as harmlessly as a number.

``run_replica_exchange`` is a Python loop over rounds whose records stay
on the device until the loop ends.

``swap_replicas_replica_sharded`` is the exchange sweep with the replica
axis over ranks (``parallel/mesh.py``): each rank holds whole replicas,
its rows of the replica-major state (``shard_chain_state``), and a partner
on the next rank is reached by sending edge rows around the ring.  A
shard's local moves are one launch of the move kernel with its replicas'
betas; its ``chain_offset`` keeps every chain's Philox stream that of the
unsharded launch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.state import (
    TENSOR_FIELDS, ChainState, init_chain_state,
)
from flowstate_tpu_torch.ops.pair_energy import SystemSpec


def temperature_ladder(t_cold: float, t_hot: float, num_replicas: int,
                       kind: str = "geometric", device="cuda") -> torch.Tensor:
    """Inverse-temperature ladder, (R,) float32 on ``device``, betas[0]
    the coldest: ``geometric`` in T (equal neighbour acceptance for a
    roughly constant heat capacity) or ``linear``."""
    if num_replicas < 2:
        raise ValueError("need at least 2 replicas")
    if kind == "geometric":
        ts = t_cold * (t_hot / t_cold) ** (np.arange(num_replicas)
                                           / (num_replicas - 1))
    elif kind == "linear":
        ts = np.linspace(t_cold, t_hot, num_replicas)
    else:
        raise ValueError(f"unknown ladder kind {kind!r}")
    return torch.as_tensor((1.0 / ts).astype(np.float32), device=device)


def chain_betas(betas: torch.Tensor, num_walkers: int) -> torch.Tensor:
    """(R * W,) beta of every chain of the replica-major state."""
    return betas.repeat_interleave(num_walkers).contiguous()


def replica_view(state: ChainState, num_replicas: int) -> ChainState:
    """The state with every tensor viewed (R, W, ...)."""
    return state.replace(**{
        f: getattr(state, f).reshape(
            (num_replicas, -1) + tuple(getattr(state, f).shape[1:]))
        for f in TENSOR_FIELDS})


def init_tempered_state(spec: SystemSpec, positions: torch.Tensor, seed: int,
                        initial_max_displacement: float = 0.5) -> ChainState:
    """State of R * W chains, replica-major, from (R, W, N, 2) positions
    (their device is the state's); the energies through
    ``init_chain_state`` (the pair-energy kernel on the card)."""
    if positions.ndim != 4:
        raise ValueError(f"positions must be (R, W, N, 2), got "
                         f"{tuple(positions.shape)}")
    return init_chain_state(spec, positions.flatten(0, 1), seed,
                            initial_max_displacement)


def run_tempered_moves(spec: SystemSpec, betas: torch.Tensor,
                       state: ChainState, num_moves: int) -> ChainState:
    """Advance every chain by ``num_moves`` local moves at its replica's
    beta: one launch of the move kernel on the card."""
    w = state.positions.shape[0] // betas.shape[0]
    return run_moves_auto(spec, chain_betas(betas, w), state, num_moves)


class SwapResult(NamedTuple):
    state: ChainState
    accepted: torch.Tensor        # (R, W) bool, True at both members of a swap
    edge_attempted: torch.Tensor  # (R,) bool, True at i iff edge i <-> i+1
    #                               was attempted (lower members)


class _Pairing(NamedTuple):
    partner: torch.Tensor   # (R,) int64
    pair_low: torch.Tensor  # (R,) int64
    valid: torch.Tensor     # (R,) bool
    lower: torch.Tensor     # (R,) bool
    d_beta: torch.Tensor    # (R,) float32


def _pairing(betas: torch.Tensor, parity: int) -> _Pairing:
    """The alternating-parity partner map: parity 0 pairs (0,1), (2,3), ...;
    parity 1 pairs (1,2), (3,4), ...; an end without a partner is not
    valid."""
    r = betas.shape[0]
    idx = np.arange(r)
    lower = (idx - parity) % 2 == 0
    partner = np.where(lower, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner <= r - 1)
    partner = np.clip(partner, 0, r - 1)
    valid = valid & (partner != idx)
    dev = betas.device
    part = torch.as_tensor(partner, device=dev)
    low = torch.as_tensor(np.minimum(idx, partner), device=dev)
    return _Pairing(part, low, torch.as_tensor(valid, device=dev),
                    torch.as_tensor(lower, device=dev), betas - betas[part])


def _swap(pairing: _Pairing, state: ChainState, u: torch.Tensor
          ) -> SwapResult:
    r = pairing.partner.shape[0]
    e = state.energy.reshape(r, -1)
    w = e.shape[1]
    log_ratio = pairing.d_beta[:, None] * (e - e[pairing.partner])
    accept = pairing.valid[:, None] & (torch.log(u[pairing.pair_low])
                                       < log_ratio)

    def take(field: torch.Tensor) -> torch.Tensor:
        f = field.reshape((r, w) + tuple(field.shape[1:]))
        mask = accept.reshape((r, w) + (1,) * (f.ndim - 2))
        return torch.where(mask, f[pairing.partner], f).reshape(field.shape)

    new_state = state.replace(positions=take(state.positions),
                              energy=take(state.energy),
                              virial=take(state.virial))
    return SwapResult(new_state, accept, pairing.lower & pairing.valid)


def swap_replicas(betas: torch.Tensor, state: ChainState,
                  generator: Optional[torch.Generator], parity: int,
                  u: Optional[torch.Tensor] = None) -> SwapResult:
    """One alternating-parity exchange sweep of the replica-major state.

    ``u`` optionally gives the (R, W) uniforms; otherwise they are drawn
    from ``generator`` on the state's device.
    """
    r = betas.shape[0]
    w = state.positions.shape[0] // r
    if u is None:
        u = torch.rand((r, w), generator=generator, device=state.device)
    return _swap(_pairing(betas, parity), state, u)


def swap_replicas_replica_sharded(betas: torch.Tensor, state: ChainState,
                                  generator: Optional[torch.Generator],
                                  parity: int, mesh,
                                  u: Optional[torch.Tensor] = None
                                  ) -> SwapResult:
    """``swap_replicas`` with the replica axis over the ranks of ``mesh``
    (a ``parallel.ChainMesh``): ``state`` is this rank's whole replicas,
    rank r holding replicas ``[r R / world, (r + 1) R / world)`` of the
    (R,) ladder ``betas``.

    A partner can live on the neighbouring rank, so each rank sends its
    last replica row (positions, energy, virial) to the right and its
    first to the left (``mesh.exchange_edge_rows``); the rows that wrap
    around the ring are masked off by ``valid``.  Every rank draws the
    same global (R, W) uniforms from ``generator`` (seeded alike on every
    rank) or takes ``u``, and both members of a pair read the lower
    index's draw, so the result is bit-equal to ``swap_replicas`` on the
    whole state.  ``accepted`` and ``edge_attempted`` are this rank's
    rows.
    """
    from flowstate_tpu_torch.parallel.mesh import exchange_edge_rows

    r_total = betas.shape[0]
    if r_total % mesh.world_size:
        raise ValueError(f"{r_total} replicas do not split over "
                         f"{mesh.world_size} ranks")
    r_local = r_total // mesh.world_size
    c, n = state.positions.shape[:2]
    if c % r_local:
        raise ValueError(f"{c} chains are not {r_local} whole replicas")
    w = c // r_local
    if u is None:
        u = torch.rand((r_total, w), generator=generator, device=state.device)
    g0 = mesh.rank * r_local
    gi = g0 + np.arange(r_local)
    lower = (gi - parity) % 2 == 0
    partner = np.where(lower, gi + 1, gi - 1)
    valid = (partner >= 0) & (partner <= r_total - 1)
    partner = np.clip(partner, 0, r_total - 1)
    dev = state.device
    ext_idx = torch.as_tensor(partner - g0 + 1, device=dev)

    # one message a side: the edge rows of the three fields side by side
    rows = torch.cat([state.positions.reshape(r_local, w * n * 2),
                      state.energy.reshape(r_local, w),
                      state.virial.reshape(r_local, w)], dim=1)
    prev_last, next_first = exchange_edge_rows(rows, mesh)
    ext = torch.cat([prev_last[None], rows, next_first[None]])[ext_idx]
    partner_pos = ext[:, :w * n * 2].reshape(c, n, 2)
    partner_e = ext[:, w * n * 2:w * (n * 2 + 1)]
    partner_v = ext[:, w * (n * 2 + 1):]

    gi_t = torch.as_tensor(gi, device=dev)
    part_t = torch.as_tensor(partner, device=dev)
    d_beta = betas[gi_t] - betas[part_t]
    log_ratio = d_beta[:, None] * (state.energy.reshape(r_local, w)
                                   - partner_e)
    accept = (torch.as_tensor(valid, device=dev)[:, None]
              & (torch.log(u[torch.minimum(gi_t, part_t)]) < log_ratio))
    chain_accept = accept.reshape(c)
    new_state = state.replace(
        positions=torch.where(chain_accept[:, None, None], partner_pos,
                              state.positions),
        energy=torch.where(chain_accept, partner_e.reshape(c), state.energy),
        virial=torch.where(chain_accept, partner_v.reshape(c), state.virial))
    return SwapResult(new_state, accept,
                      torch.as_tensor(lower & valid, device=dev))


class ReplicaExchangeResult(NamedTuple):
    state: ChainState
    # fraction of accepted swaps per ladder edge i <-> i+1, (R-1,)
    edge_acceptance: torch.Tensor
    # the trajectory after every round: record='cold' keeps the cold
    # replica, (T, W, N, 2) / (T, W); record='all' every replica (for
    # MBAR, analysis/mbar.py), (T, R, W, N, 2) / (T, R, W)
    cold_positions: torch.Tensor
    cold_energy: torch.Tensor
    # record_fn(view) outputs stacked over rounds (None without record_fn)
    extras: object


RecordFn = Callable[[ChainState], object]


def run_replica_exchange(spec: SystemSpec, betas: torch.Tensor,
                         state: ChainState,
                         generator: Optional[torch.Generator],
                         num_rounds: int, moves_per_round: int,
                         record: str = "cold",
                         record_fn: Optional[RecordFn] = None
                         ) -> ReplicaExchangeResult:
    """The PT loop: per round, local moves at every temperature (one
    move-kernel launch) and one exchange sweep, parity ``round % 2``, its
    uniforms drawn from ``generator``; the trajectory recorded after every
    round.

    ``record='cold'`` keeps the target-temperature replica, ``'all'``
    every replica.  ``record_fn`` receives the (R, W) ``replica_view`` of
    the state after the swap and returns a tensor or a tuple of tensors,
    which are stacked over rounds into ``extras``.  Every record stays on
    the state's device.
    """
    if record not in ("cold", "all"):
        raise ValueError(f"unknown record mode {record!r}")
    if num_rounds < 1:
        raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
    r = betas.shape[0]
    c = state.positions.shape[0]
    if c % r:
        raise ValueError(f"{c} chains do not split into {r} replicas")
    w = c // r
    beta_c = chain_betas(betas, w)
    pairings = [_pairing(betas, p) for p in (0, 1)]
    acc_rows, positions, energies, extras = [], [], [], []
    for i in range(num_rounds):
        state = run_moves_auto(spec, beta_c, state, moves_per_round)
        u = torch.rand((r, w), generator=generator, device=state.device)
        res = _swap(pairings[i % 2], state, u)
        state = res.state
        acc_rows.append(res.accepted.float().mean(dim=1))
        if record == "all":
            positions.append(state.positions.unflatten(0, (r, w)))
            energies.append(state.energy.reshape(r, w))
        else:
            positions.append(state.positions[:w])
            energies.append(state.energy[:w])
        if record_fn is not None:
            extras.append(record_fn(replica_view(state, r)))
    # edge i <-> i+1 is counted at its lower member in the rounds of its
    # parity: an upper member's flag belongs to the edge below it
    edges = [(p.lower & p.valid)[:-1].float() for p in pairings]
    attempted = torch.stack([edges[i % 2] for i in range(num_rounds)])
    acc = torch.stack(acc_rows)[:, :-1] * attempted
    edge_acceptance = acc.sum(0) / torch.clamp(attempted.sum(0), min=1.0)
    stacked = None
    if record_fn is not None:
        if isinstance(extras[0], tuple):
            stacked = tuple(torch.stack(x) for x in zip(*extras))
        else:
            stacked = torch.stack(extras)
    return ReplicaExchangeResult(state, edge_acceptance,
                                 torch.stack(positions), torch.stack(energies),
                                 stacked)
