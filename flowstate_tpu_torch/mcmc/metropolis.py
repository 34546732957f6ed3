"""Batched NVT Metropolis engine in plain PyTorch.

Port of ``flowstate_tpu/mcmc/metropolis.py``.  The JAX engine is written
for one chain and vmapped; here each function acts on the whole (C, ...)
batch, and the scans over moves and sample blocks are Python loops.

This engine is the move kernel's plain version and its oracle: on the
card, one move costs some forty small launches, so the experiments run their
move segments through ``cuda_metropolis`` instead.  Hard-core overlaps
follow the JAX semantics: a proposed overlap gives ``delta_e = +inf``,
``exp(-beta * inf) == 0`` and the move is rejected.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Tuple

import torch

from flowstate_tpu_torch.mcmc.state import ChainState
from flowstate_tpu_torch.ops.box import wrap_pbc
from flowstate_tpu_torch.ops.pair_energy import (
    SystemSpec, particle_energy_virial, pressure,
)
from flowstate_tpu_torch.utils.profiling import annotate

# Random tables are drawn per chunk of this many moves, as in the JAX engine.
RNG_CHUNK = 256

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
MoveFn = Callable[[ChainState, int], ChainState]


def propose(spec: SystemSpec, state: ChainState, p: torch.Tensor,
            disp_unit: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move particle ``p[c]`` of each chain by ``(disp_unit - 0.5) *
    max_disp``, wrapped into the box.

    Returns the proposed (C, N, 2) positions and the energy and virial
    changes, (C,) each.
    """
    c, n = state.positions.shape[0], state.positions.shape[1]
    p = p.long()
    eno, viro = particle_energy_virial(spec, state.positions, p)
    old_p = state.positions[torch.arange(c, device=state.device), p]
    # old + (u - 0.5) * max_disp rounded once, as a fused multiply-add: XLA
    # contracts the JAX engine's expression so and the kernel uses fmaf.
    # In float64 the product is exact, so one rounding to float32 remains.
    moved = (old_p.double() + (disp_unit - 0.5).double()
             * state.max_disp[:, None].double()).to(old_p.dtype)
    moved = wrap_pbc(moved, spec.box)
    onehot = (torch.arange(n, device=state.device)[None, :]
              == p[:, None])[..., None]                  # (C, N, 1)
    new_positions = torch.where(onehot, moved[:, None, :], state.positions)
    enn, virn = particle_energy_virial(spec, new_positions, p)
    return new_positions, enn - eno, virn - viro


def apply_move(spec: SystemSpec, beta, state: ChainState,
               p: torch.Tensor, disp_unit: torch.Tensor, u: torch.Tensor,
               margin_out: Optional[torch.Tensor] = None) -> ChainState:
    """One Metropolis update of every chain from given randoms.

    p: (C,) particle indices, disp_unit: (C, 2) uniforms in [0, 1),
    u: (C,) acceptance uniforms; ``beta`` is a float or a (C,) tensor of
    each chain's own (it broadcasts).  If ``margin_out`` is given it receives
    ``exp(-beta dE) - u``, which is positive exactly where the move is
    accepted: the distance of each decision from a tie.
    """
    new_positions, delta_e, delta_v = propose(spec, state, p, disp_unit)
    ratio = torch.exp(-beta * delta_e)
    accept = (delta_e <= 0.0) | (u < ratio)
    if margin_out is not None:
        margin_out.copy_(ratio - u)
    zero = torch.zeros_like(delta_e)
    return state.replace(
        positions=torch.where(accept[:, None, None], new_positions,
                              state.positions),
        energy=state.energy + torch.where(accept, delta_e, zero),
        virial=state.virial + torch.where(accept, delta_v, zero),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.to(state.accepts.dtype),
    )


def generator_for(state: ChainState) -> torch.Generator:
    """The plain engine's generator for the next segment of ``state``,
    seeded from a hash of ``(seed, calls)`` (the CPU generator keeps only
    the low 32 bits of its seed, so both must reach those bits)."""
    digest = hashlib.blake2b(f"{state.seed},{state.calls}".encode(),
                             digest_size=8).digest()
    g = torch.Generator(device=state.device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def draw_tables(spec: SystemSpec, num_chains: int, num_moves: int,
                generator: torch.Generator, device) -> Tables:
    """Random tables for ``num_moves`` moves of each chain:
    ``p_tab`` (C, T) int32, ``d_tab`` (C, T, 2) and ``u_tab`` (C, T)
    float32 uniforms in [0, 1)."""
    p_tab = torch.randint(0, spec.num_particles, (num_chains, num_moves),
                          generator=generator, device=device,
                          dtype=torch.int32)
    d_tab = torch.rand((num_chains, num_moves, 2), generator=generator,
                       device=device)
    u_tab = torch.rand((num_chains, num_moves), generator=generator,
                       device=device)
    return p_tab, d_tab, u_tab


def run_moves(spec: SystemSpec, beta, state: ChainState,
              num_moves: int, tables: Optional[Tables] = None,
              margin_log: Optional[torch.Tensor] = None) -> ChainState:
    """``num_moves`` sequential moves of every chain.

    The randoms come from ``tables`` when given (each with T = num_moves
    columns) and are otherwise drawn, ``RNG_CHUNK`` moves at a time, from
    ``generator_for(state)``: the tables of every chain of the run, of
    which a shard keeps its ``global_rows()``, so that it moves its chains
    as the unsharded run does (each rank pays for the whole draw).
    ``margin_log`` (C, T) float32, if given,
    receives each move's ``exp(-beta dE) - u``.  ``beta``: a float or
    (C,) per chain.  Advances ``calls``.
    """
    def chunks():
        if tables is not None:
            yield 0, tables
            return
        g = generator_for(state)
        rows = state.global_rows()
        for start in range(0, num_moves, RNG_CHUNK):
            drawn = draw_tables(spec, state.num_global_chains,
                                min(RNG_CHUNK, num_moves - start), g,
                                state.device)
            yield start, tuple(t[rows] for t in drawn)

    for start, (p_tab, d_tab, u_tab) in chunks():
        for i in range(p_tab.shape[1]):
            margin = (margin_log[:, start + i] if margin_log is not None
                      else None)
            state = apply_move(spec, beta, state, p_tab[:, i], d_tab[:, i],
                               u_tab[:, i], margin)
    return state.replace(calls=state.calls + 1)


def metropolis_move(spec: SystemSpec, beta, state: ChainState,
                    tables: Optional[Tables] = None) -> ChainState:
    """One displacement attempt of every chain: ``run_moves`` of one move
    (JAX's ``metropolis_move`` is the same step for one chain).  Its
    randoms come from ``tables`` ((C, 1) columns) or are drawn; advances
    ``calls``."""
    return run_moves(spec, beta, state, 1, tables)


def adjust_displacement(state: ChainState,
                        target_acceptance: float = 0.5) -> ChainState:
    """Adaptive max displacement: factor = block acceptance / target,
    clamped to [0.5, 1.5]; no-op for chains without attempts since the
    previous adjustment."""
    delta_att = state.attempts - state.prev_attempts
    delta_acc = state.accepts - state.prev_accepts
    any_attempts = delta_att > 0
    frac = torch.where(
        any_attempts,
        delta_acc.to(torch.float32)
        / torch.clamp(delta_att, min=1).to(torch.float32),
        torch.zeros_like(state.max_disp))
    factor = torch.clamp(frac / target_acceptance, 0.5, 1.5)
    return state.replace(
        max_disp=torch.where(any_attempts, state.max_disp * factor,
                             state.max_disp),
        prev_attempts=torch.where(any_attempts, state.attempts,
                                  state.prev_attempts),
        prev_accepts=torch.where(any_attempts, state.accepts,
                                 state.prev_accepts),
    )


@dataclasses.dataclass(frozen=True)
class Observables:
    """Observable samples; leaves are (C,) for one sample and (C, T) (plus
    the (N, 2) of ``positions``) for a stacked run."""

    cycle: torch.Tensor
    energy_per_particle: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    box_size_x: torch.Tensor
    box_size_y: torch.Tensor
    positions: torch.Tensor

    def numpy(self) -> "Observables":
        """Host numpy copy."""
        return Observables(**{k: v.detach().cpu().numpy()
                              for k, v in vars(self).items()})


def sample_observables(spec: SystemSpec, beta: float, state: ChainState,
                       cycle: int) -> Observables:
    n = spec.num_particles
    return Observables(
        cycle=torch.full_like(state.attempts, int(cycle)),
        energy_per_particle=state.energy / n,
        density=torch.full_like(state.energy, n / spec.box.volume),
        pressure=pressure(spec, state.virial, beta),
        box_size_x=torch.full_like(state.energy, spec.box.size_x),
        box_size_y=torch.full_like(state.energy, spec.box.size_y),
        positions=state.positions,
    )


def run_production_with(spec: SystemSpec, beta: float, state: ChainState,
                        num_samples: int, sampling_frequency: int,
                        move_fn: MoveFn, start_cycle: int = 0
                        ) -> Tuple[ChainState, Observables]:
    """``num_samples`` blocks of ``move_fn(state, sampling_frequency)``,
    one observable sample after each; leaves come back (C, T, ...).  Each
    block is a span ``mcmc.block``, its sample a span ``mcmc.observe``."""
    samples = []
    for i in range(num_samples):
        with annotate("mcmc.block"):
            state = move_fn(state, sampling_frequency)
            with annotate("mcmc.observe"):
                samples.append(sample_observables(
                    spec, beta, state,
                    start_cycle + (i + 1) * sampling_frequency))
    if not samples:
        raise ValueError("num_samples must be at least 1")
    return state, Observables(**{
        k: torch.stack([vars(s)[k] for s in samples], dim=1)
        for k in vars(samples[0])})


def run_production(spec: SystemSpec, beta: float, state: ChainState,
                   num_samples: int, sampling_frequency: int,
                   start_cycle: int = 0, tables: Optional[Tables] = None
                   ) -> Tuple[ChainState, Observables]:
    """``num_samples`` blocks of ``sampling_frequency`` moves of this
    engine, one observable sample after each; leaves (C, T, ...).  The
    randoms come from ``tables`` ((C, num_samples * sampling_frequency)
    columns, block after block) or are drawn per block."""
    def move_fn(s: ChainState, num_moves: int) -> ChainState:
        if tables is None:
            return run_moves(spec, beta, s, num_moves)
        start = (s.calls - calls0) * num_moves
        return run_moves(spec, beta, s, num_moves,
                         tuple(t[:, start:start + num_moves] for t in tables))

    calls0 = state.calls
    return run_production_with(spec, beta, state, num_samples,
                               sampling_frequency, move_fn, start_cycle)


def run_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                      num_steps: int, adjusting_frequency: int,
                      target_acceptance: float = 0.5,
                      move_fn: Optional[MoveFn] = None) -> ChainState:
    """Every ``adjusting_frequency`` moves adapt the displacement; the
    remainder moves run after the last full block.  ``move_fn`` defaults
    to this module's ``run_moves``."""
    if move_fn is None:
        move_fn = lambda s, n: run_moves(spec, beta, s, n)  # noqa: E731
    num_blocks, remainder = divmod(num_steps, adjusting_frequency)
    for _ in range(num_blocks):
        state = adjust_displacement(move_fn(state, adjusting_frequency),
                                    target_acceptance)
    if remainder > 0:
        state = move_fn(state, remainder)
    return state


# JAX's batched front ends vmap its one-chain functions over the chains;
# this engine is batched already, so they are the same functions.
run_moves_batch = run_moves
run_production_batch = run_production
run_equilibration_batch = run_equilibration
run_production_with_batch = run_production_with
