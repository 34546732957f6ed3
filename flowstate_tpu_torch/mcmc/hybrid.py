"""Flow-proposed independence ("big") moves, batched over chains.

Port of ``flowstate_tpu/mcmc/hybrid.py``: ``BigMoveResult``,
``to_centered`` (:38), ``to_box_frame`` (:44), ``nf_big_moves`` (:51),
``apply_big_moves`` (:97), ``judge_flow`` (:150) and ``bulk_judge_flow``
(:162).  The port's ``ChainState`` has no per-chain key, so the
proposals and the acceptance uniforms come from an explicit
``torch.Generator``.  The proposals' energies go through
``state.batched_energy_virial``: on the card, one launch of the
pair-energy kernel for all chains.

The Metropolis-Hastings ratio of an independence move is

    log A = -beta (U_new - U_old) + log q(x_old) - log q(x_new),

the corrected sign (the reference fork's inverted Hastings term converges
to ΔF ≈ 0.66 instead of the exact 1.49).  An infinite proposal energy
gives log A = -inf and rejects.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from flowstate_tpu_torch.mcmc.state import ChainState, batched_energy_virial
from flowstate_tpu_torch.ops.pair_energy import SystemSpec
from flowstate_tpu_torch.utils.profiling import annotate


class BigMoveResult(NamedTuple):
    state: ChainState
    accepted: torch.Tensor         # (C,) bool
    ratio_log: torch.Tensor        # (C,) the MH log-ratio per chain
    proposal_energy: torch.Tensor  # (C,)


def to_centered(positions: torch.Tensor, half_box: float) -> torch.Tensor:
    """MC box frame [0, L)^2 (C, N, 2) -> the flow's centred frame,
    flattened (C, N*2)."""
    return (positions - half_box).reshape(*positions.shape[:-2], -1)


def to_box_frame(flat: torch.Tensor, num_particles: int,
                 half_box: float) -> torch.Tensor:
    """The flow's centred (C, N*2) -> the MC box frame (C, N, 2)."""
    return flat.reshape(*flat.shape[:-1], num_particles, 2) + half_box


def _energies(spec: SystemSpec, positions: torch.Tensor):
    return batched_energy_virial(
        spec, positions.to(torch.float32).contiguous())


@torch.no_grad()
def nf_big_moves(spec: SystemSpec, beta: float, state: ChainState, model,
                 half_box: float, generator: torch.Generator,
                 paired: bool = True) -> BigMoveResult:
    """One flow-proposed independence move per chain.

    ``paired`` runs the proposal sweep and the current point's log q in
    one lockstep pass (``sample_and_log_prob_with_old``); otherwise the
    proposal and its log q come from one forward pass and the current
    point's log q from an inverse pass in ``apply_big_moves``.
    """
    c = state.positions.shape[0]
    u = torch.rand(c, generator=generator, device=state.device)
    if paired:
        prop_flat, log_q_new, log_q_old = model.sample_and_log_prob_with_old(
            c, to_centered(state.positions, half_box).to(model.dtype),
            generator)
    else:
        prop_flat, log_q_new = model.sample_and_log_prob(c, generator)
        log_q_old = None
    proposals = to_box_frame(prop_flat, spec.num_particles, half_box)
    return apply_big_moves(spec, beta, state, proposals, log_q_new, model,
                           half_box, u, log_q_old=log_q_old)


@torch.no_grad()
def apply_big_moves(spec: SystemSpec, beta: float, state: ChainState,
                    proposals: torch.Tensor, log_q_new: torch.Tensor, model,
                    half_box: float, u: torch.Tensor,
                    log_q_old: Optional[torch.Tensor] = None
                    ) -> BigMoveResult:
    """Accept or reject given proposals (C, N, 2) with uniforms ``u``
    (C,).  ``log_q_old`` is computed here by an inverse pass when not
    given.  Adds one to every chain's ``attempts`` and the accepted moves
    to ``accepts``.  A span ``hybrid.verdict``."""
    with annotate("hybrid.verdict"):
        enn, virn = _energies(spec, proposals)
        if log_q_old is None:
            log_q_old = model.log_prob(
                to_centered(state.positions, half_box).to(model.dtype))
        delta_e = enn - state.energy
        ratio_log = (-beta * delta_e
                     + (log_q_old - log_q_new).to(delta_e.dtype))
        accept = u < torch.exp(ratio_log)
        new_state = state.replace(
            positions=torch.where(accept[:, None, None],
                                  proposals.to(state.positions.dtype),
                                  state.positions).contiguous(),
            energy=torch.where(accept, enn.to(state.energy.dtype),
                               state.energy),
            virial=torch.where(accept, virn.to(state.virial.dtype),
                               state.virial),
            attempts=state.attempts + 1,
            accepts=state.accepts + accept.to(state.accepts.dtype),
        )
        return BigMoveResult(new_state, accept, ratio_log, enn)


@torch.no_grad()
def judge_flow(spec: SystemSpec, beta: float, state: ChainState,
               proposals: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """Energy-only Metropolis verdict per chain, without accepting."""
    enn, _ = _energies(spec, proposals)
    delta_e = enn - state.energy
    u = torch.rand(delta_e.shape, generator=generator, device=delta_e.device)
    return (delta_e <= 0.0) | (u < torch.exp(-beta * delta_e))


@torch.no_grad()
def bulk_judge_flow(spec: SystemSpec, beta: float, configs: torch.Tensor,
                    ref_energy: torch.Tensor, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, int]:
    """Metropolis verdicts of a batch against one reference energy:
    (number accepted, number attempted)."""
    enn, _ = _energies(spec, configs)
    delta_e = enn - ref_energy
    u = torch.rand(delta_e.shape, generator=generator, device=delta_e.device)
    accepted = (delta_e <= 0.0) | (u < torch.exp(-beta * delta_e))
    return torch.sum(accepted), configs.shape[0]
