"""Blocked conditional-flow moves: resample k particles given the rest.

Port of ``flowstate_tpu/mcmc/blocked.py``: ``random_block_onehots`` (:49)
as ``random_block_perm``, ``select_particles`` (:68), ``scatter_block``
(:74), ``block_context`` and ``context_dim`` (:86, :102),
``fourier_context`` and ``fourier_context_dim`` (:107, :138), and
``blocked_big_moves`` (:143), split as ``mcmc/hybrid.py`` splits the
global move: ``blocked_big_moves`` draws from a ``torch.Generator`` and
``apply_blocked_moves`` takes the draws as tensors.

A blocked move picks a uniformly random k-subset of each chain's
particles, proposes new positions for it from a flow conditioned on the
other N-k (``flows/models.py::ConditionalNormalizingFlow``, its context
built from those N-k positions only) and accepts with

    log A = -beta (U_new - U_old) + log q(old_block | rest)
            - log q(new_block | rest),

the independence move's corrected Hastings sign (``mcmc/hybrid.py``).  The
reverse move draws the same subset with the same probability and sees the
same context, so detailed balance holds.  The proposals' energies go
through ``hybrid._energies``: on the card, one launch of the pair-energy
kernel for all chains.

The JAX module selects and scatters particles by one-hot einsums because
gathers are slow on the TPU (blocked.py:28-30).  Here they are
``torch.gather`` and ``scatter``: both move exact values (a one-hot
product adds exact zeros), so they give the same numbers bit for bit.
A block is the first k entries of a per-chain permutation (C, N), the
context the other N-k in the permutation's order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from flowstate_tpu_torch.mcmc.hybrid import BigMoveResult, _energies
from flowstate_tpu_torch.mcmc.state import ChainState
from flowstate_tpu_torch.ops.pair_energy import SystemSpec

ContextFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def random_block_perm(batch: int, n: int, generator: torch.Generator,
                      device) -> torch.Tensor:
    """(B, N) uniformly random permutations (argsort of uniforms): the
    first k entries of a row are its block, in a random order, the rest
    its conditioning particles, in a random order; every k-subset is
    equally likely."""
    u = torch.rand((batch, n), generator=generator, device=device)
    return torch.argsort(u, dim=-1)


def select_particles(idx: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
    """(B, m) particle indices into (B, N, d) positions -> (B, m, d)."""
    return torch.gather(positions, 1, idx[..., None].expand(
        *idx.shape, positions.shape[-1]))


def scatter_block(idx: torch.Tensor, block: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """``positions`` (B, N, d) with the rows ``idx`` (B, k) replaced by
    ``block`` (B, k, d); the others keep their coordinates."""
    return positions.scatter(1, idx[..., None].expand(*block.shape), block)


def block_context(rest: torch.Tensor, positions: torch.Tensor,
                  half_box: float) -> torch.Tensor:
    """The raw-coordinate context, (B, 4 (N-k)): cos and sin at scale
    pi / half_box of the N-k conditioning particles' centred coordinates,
    in the permutation's order."""
    others = select_particles(rest, positions) - half_box
    flat = others.reshape(others.shape[0], -1)
    scale = math.pi / half_box
    return torch.cat([torch.cos(scale * flat), torch.sin(scale * flat)],
                     dim=-1)


def context_dim(n: int, k: int, num_dim: int = 2) -> int:
    """Width of ``block_context``."""
    return 2 * (n - k) * num_dim


def _fourier_modes(m_max: int) -> np.ndarray:
    ms = np.arange(-m_max, m_max + 1)
    mx, my = np.meshgrid(ms, ms, indexing="ij")
    return np.stack([mx.ravel(), my.ravel()], -1)        # (M, 2)


def fourier_context(rest: torch.Tensor, positions: torch.Tensor,
                    half_box: float, m_max: int = 3) -> torch.Tensor:
    """The order-invariant context, (B, 2 (2 m_max + 1)^2): the torus
    density modes of the conditioning particles,

        c_m = (1 / (N-k)) sum_j exp(i 2 pi / L m . r_j),  |m_x|, |m_y| <= m_max,

    as the cos sums then the sin sums, from box-frame positions."""
    others = select_particles(rest, positions)           # (B, N-k, 2)
    modes = torch.as_tensor(_fourier_modes(m_max), dtype=others.dtype,
                            device=others.device)
    phase = (math.pi / half_box) * torch.einsum("bnd,md->bnm", others,
                                                 modes)
    nk = max(others.shape[-2], 1)
    return torch.cat([torch.cos(phase).sum(dim=-2),
                      torch.sin(phase).sum(dim=-2)], dim=-1) / nk


def fourier_context_dim(m_max: int = 3) -> int:
    """Width of ``fourier_context``."""
    return 2 * (2 * m_max + 1) ** 2


@torch.no_grad()
def blocked_big_moves(spec: SystemSpec, beta: float, state: ChainState,
                      model, half_box: float, k: int,
                      generator: torch.Generator,
                      context_fn: Optional[ContextFn] = None,
                      paired: bool = True) -> BigMoveResult:
    """One blocked move per chain: the blocks, the base points and the
    acceptance uniforms drawn from ``generator``, in that order, then
    ``apply_blocked_moves``."""
    c, n = state.positions.shape[:2]
    perm = random_block_perm(c, n, generator, state.device)
    z = model.base_sample(c, generator)
    u = torch.rand(c, generator=generator, device=state.device)
    return apply_blocked_moves(spec, beta, state, perm, z, u, model,
                               half_box, k, context_fn, paired)


@torch.no_grad()
def apply_blocked_moves(spec: SystemSpec, beta: float, state: ChainState,
                        perm: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
                        model, half_box: float, k: int,
                        context_fn: Optional[ContextFn] = None,
                        paired: bool = True) -> BigMoveResult:
    """Blocked moves given the draws: ``perm`` (C, N) whose first ``k``
    entries are each chain's block, the flow's base points ``z`` (C, 2k)
    and the uniforms ``u`` (C,).

    ``model`` is a ``ConditionalNormalizingFlow`` over the block's 2k
    centred coordinates; ``context_fn(rest, positions)`` builds its
    context from the other particles' indices (C, N-k) and the box-frame
    positions (default ``block_context``), and must be the one it was
    trained with (``training/blocked.py``).  ``paired`` runs the proposal
    sweep and the old block's log q in one paired loop.  Adds one to
    every chain's ``attempts`` and the accepted moves to ``accepts``.
    """
    c = state.positions.shape[0]
    if context_fn is None:
        context_fn = lambda r, p: block_context(r, p, half_box)  # noqa: E731
    sel, rest = perm[:, :k], perm[:, k:]
    ctx = context_fn(rest, state.positions).to(model.dtype)
    old_flat = (select_particles(sel, state.positions)
                - half_box).reshape(c, -1).to(model.dtype)
    new_flat, log_q_new, log_q_old = model.push_forward_with_old(
        z.to(model.dtype), old_flat, ctx, paired=paired)
    new_block = new_flat.reshape(c, k, 2).to(state.positions.dtype) + half_box
    proposals = scatter_block(sel, new_block, state.positions)

    enn, virn = _energies(spec, proposals)
    ratio_log = (-beta * (enn - state.energy)
                 + (log_q_old - log_q_new).to(enn.dtype))
    accept = u < torch.exp(ratio_log)
    new_state = state.replace(
        positions=torch.where(accept[:, None, None], proposals,
                              state.positions).contiguous(),
        energy=torch.where(accept, enn.to(state.energy.dtype), state.energy),
        virial=torch.where(accept, virn.to(state.virial.dtype),
                           state.virial),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.to(state.accepts.dtype),
    )
    return BigMoveResult(new_state, accept, ratio_log, enn)
