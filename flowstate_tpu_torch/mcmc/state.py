"""Chain state for the batched Metropolis engine.

Port of ``flowstate_tpu/mcmc/state.py``.  ``ChainState`` is a frozen
dataclass of tensors with a leading chains axis C, advanced by functions
that return a new state.  The JAX per-chain PRNG key becomes two integers:
``seed`` (fixed for a run) and ``calls``, which every move segment
advances, so that no two segments draw the same random stream.  The move
kernel keys its counter-based generator on ``(seed, chain)`` with counter
``(move, calls)``; the plain engine seeds a ``torch.Generator`` from
``(seed, calls)``.

A state may be one rank's rows of a run sharded over ranks
(``parallel/mesh.py::shard_chain_state``): ``chain_offset`` is the global
index of its chain 0 and ``total_chains`` the run's chain count (None:
its own rows).  The move kernel keys chain c on ``chain_offset + c``, and
the plain engines draw the run's whole table and keep ``global_rows()``,
so a shard moves its chains exactly as the unsharded run does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from flowstate_tpu_torch.ops.cuda_pair import (
    total_energy_virial_kernel, total_energy_virial_plain,
)
from flowstate_tpu_torch.ops.pair_energy import SystemSpec
from flowstate_tpu_torch.utils.profiling import annotate

TENSOR_FIELDS = ("positions", "energy", "virial", "max_disp", "attempts",
                 "accepts", "prev_attempts", "prev_accepts")


@dataclasses.dataclass(frozen=True)
class ChainState:
    positions: torch.Tensor      # (C, N, 2) float32
    energy: torch.Tensor         # (C,) float32
    virial: torch.Tensor         # (C,) float32
    max_disp: torch.Tensor       # (C,) float32
    attempts: torch.Tensor       # (C,) int32
    accepts: torch.Tensor        # (C,) int32
    prev_attempts: torch.Tensor  # (C,) int32
    prev_accepts: torch.Tensor   # (C,) int32
    seed: int = 0
    calls: int = 0               # move segments run so far
    chain_offset: int = 0        # global index of chain 0 in a sharded run
    total_chains: Optional[int] = None  # the run's chains; None: its own

    def replace(self, **changes) -> "ChainState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def num_global_chains(self) -> int:
        """The chains of the whole run (this state's own if unsharded)."""
        if self.total_chains is None:
            return self.positions.shape[0]
        return self.total_chains

    def global_rows(self) -> slice:
        """This state's rows of a table drawn for every chain of the run."""
        start, stop = self.chain_offset, (self.chain_offset
                                          + self.positions.shape[0])
        if start < 0 or stop > self.num_global_chains:
            raise ValueError(f"chains [{start}, {stop}) are not rows of a "
                             f"run of {self.num_global_chains}")
        return slice(start, stop)


def batched_energy_virial(spec: SystemSpec, positions: torch.Tensor,
                          chunk_elems: int = 2 ** 28):
    """Per-chain (energy, virial) of a (C, N, 2) batch: the pair-energy
    kernel for a CUDA batch, its plain version (in chain chunks of at most
    ``chunk_elems`` pair-tensor elements) for a CPU batch; a span
    ``pair.energy``."""
    with annotate("pair.energy"):
        if positions.device.type == "cuda":
            return total_energy_virial_kernel(spec, positions)
        if positions.device.type == "cpu":
            return total_energy_virial_plain(spec, positions, chunk_elems)
    raise ValueError(f"no pair-energy engine for device {positions.device}")


def init_chain_state(spec: SystemSpec, positions: torch.Tensor, seed: int,
                     initial_max_displacement: float = 0.5) -> ChainState:
    """State for a (C, N, 2) batch of chains on ``positions.device``."""
    if positions.ndim != 3 or positions.shape[1:] != (spec.num_particles, 2):
        raise ValueError(f"positions must be (C, {spec.num_particles}, 2), "
                         f"got {tuple(positions.shape)}")
    positions = positions.to(torch.float32).contiguous()
    c = positions.shape[0]
    energy, virial = batched_energy_virial(spec, positions)
    zeros_i = torch.zeros(c, dtype=torch.int32, device=positions.device)
    return ChainState(
        positions=positions,
        energy=energy.to(torch.float32),
        virial=virial.to(torch.float32),
        max_disp=torch.full((c,), initial_max_displacement,
                            dtype=torch.float32, device=positions.device),
        attempts=zeros_i,
        accepts=zeros_i.clone(),
        prev_attempts=zeros_i.clone(),
        prev_accepts=zeros_i.clone(),
        seed=int(seed),
    )


def chain_state_from_numpy(arrays: Mapping[str, np.ndarray], seed: int,
                           device) -> ChainState:
    """A state from host arrays named like the fields (a JAX ``ChainState``
    with its leaves as numpy arrays; its key does not carry over)."""
    dtypes = {f: torch.float32 for f in TENSOR_FIELDS[:4]}
    dtypes.update({f: torch.int32 for f in TENSOR_FIELDS[4:]})
    return ChainState(
        **{f: torch.tensor(np.asarray(arrays[f]), dtype=dtypes[f],
                           device=device)
           for f in TENSOR_FIELDS},
        seed=int(seed))


def resync_energy(spec: SystemSpec, state: ChainState) -> ChainState:
    """Recompute the cached energy and virial from the positions (clears
    fp32 drift, and the NaN virial the move kernel leaves)."""
    energy, virial = batched_energy_virial(spec, state.positions)
    return state.replace(energy=energy.to(state.energy.dtype),
                         virial=virial.to(state.virial.dtype))
