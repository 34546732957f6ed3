"""Total energy and virial of a batch of configurations: the hand-written
CUDA kernel and its plain PyTorch version.

Port of ``flowstate_tpu/ops/pallas_pair.py``: ``total_energy_virial_kernel``
is the counterpart of ``total_energy_virial_pallas`` and launches
``csrc/pair_energy.cu`` (which replaces ``_pair_tile_kernel``), batched over
chains: a (C, N, 2) float32 CUDA batch in, (energy, virial) of shape (C,)
out, with any hard-core overlap mapped to (+inf, +inf).  One call is two
launches, the tile pass and the epilogue; ``LAUNCHES`` counts launches.
``total_energy_virial_plain`` is its plain version: ``total_energy_virial``
in chain chunks.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from flowstate_tpu_torch.ops.pair_energy import SystemSpec, total_energy_virial
from flowstate_tpu_torch.ops.potentials import well_centers

TILE = 256        # particles per tile, as csrc/pair_energy.cu's kTile
LAUNCHES = 0      # kernel launches in this process (two per call)


class _PairParams(ctypes.Structure):
    """Mirror of ``PairParams`` in ``csrc/pair_energy.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("num_chains", "n", "num_tiles", "num_wells")] + [
        (name, ctypes.c_float) for name in
        ("lx", "ly", "inv_lx", "inv_ly", "r_cut2", "hc2", "sigma2", "eps4",
         "eps48", "shift", "wx0", "wy0", "wx1", "wy1", "v00", "v01", "r0",
         "k")]


def num_tiles(n: int) -> int:
    return (n + TILE - 1) // TILE


def num_tile_pairs(n: int) -> int:
    """Blocks per chain of the tile pass: tile pairs (i, j) with j >= i."""
    t = num_tiles(n)
    return t * (t + 1) // 2


def _params(spec: SystemSpec, num_chains: int) -> _PairParams:
    lx, ly = spec.box.size_x, spec.box.size_y
    r_cut2 = spec.cutoff * spec.cutoff
    sr6_cut = (spec.sigma ** 2 / r_cut2) ** 3
    centers = well_centers(lx, ly, 2)
    v0 = list(spec.V0_list) + [0.0] * 2
    return _PairParams(
        num_chains=num_chains, n=spec.num_particles,
        num_tiles=num_tiles(spec.num_particles), num_wells=spec.num_wells,
        lx=lx, ly=ly, inv_lx=1.0 / lx, inv_ly=1.0 / ly,
        r_cut2=r_cut2, hc2=spec.hard_core * spec.hard_core,
        sigma2=spec.sigma ** 2, eps4=4.0 * spec.epsilon,
        eps48=48.0 * spec.epsilon,
        shift=4.0 * spec.epsilon * (sr6_cut * sr6_cut - sr6_cut),
        wx0=centers[0][0], wy0=centers[0][1],
        wx1=centers[1][0], wy1=centers[1][1],
        v00=v0[0], v01=v0[1], r0=spec.r0, k=spec.k)


def _entry_points():
    from flowstate_tpu_torch.kernels import build

    lib = build.build().libs["pair_energy"]
    tiles, epilogue = lib.flowstate_pair_tiles, lib.flowstate_pair_epilogue
    tiles.argtypes = [ctypes.POINTER(_PairParams)] + [ctypes.c_void_p] * 5
    epilogue.argtypes = [ctypes.POINTER(_PairParams)] + [ctypes.c_void_p] * 7
    tiles.restype = epilogue.restype = ctypes.c_int
    return tiles, epilogue


def _check_positions(spec: SystemSpec, positions: torch.Tensor) -> None:
    """Raise unless ``positions`` is a contiguous (C, N, 2) float32 batch
    with C >= 1 and at most 65,535 tile pairs (N up to about 92,000)."""
    n = spec.num_particles
    if positions.ndim != 3 or positions.shape[1:] != (n, 2):
        raise ValueError(f"positions must be (C, {n}, 2), "
                         f"got {tuple(positions.shape)}")
    if positions.shape[0] < 1 or n < 1:
        raise ValueError("positions must hold at least one chain and one "
                         "particle")
    if positions.dtype != torch.float32:
        raise ValueError(f"positions must be float32, got {positions.dtype}")
    if not positions.is_contiguous():
        raise ValueError("positions must be contiguous")
    if positions.data_ptr() % 8:
        raise ValueError("positions must start on an 8-byte boundary (the "
                         "kernel reads (x, y) as one float2)")
    if spec.num_wells not in (0, 1, 2):
        raise ValueError(f"num_wells must be 0, 1 or 2, got {spec.num_wells}")
    if num_tile_pairs(n) > 65535:
        raise ValueError(f"N={n} needs {num_tile_pairs(n)} tile pairs; the "
                         f"kernel's grid takes at most 65535")


def total_energy_virial_kernel(spec: SystemSpec, positions: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy and virial, (C,) float32 each, of every configuration of a
    (C, N, 2) float32 CUDA batch, in two launches on the current stream."""
    global LAUNCHES
    _check_positions(spec, positions)
    if positions.device.type != "cuda":
        raise ValueError("total_energy_virial_kernel takes CUDA tensors, got "
                         f"{positions.device}; total_energy_virial_plain "
                         "takes CPU tensors")
    c, dev = positions.shape[0], positions.device
    p = num_tile_pairs(spec.num_particles)
    part_e = torch.empty((c, p), dtype=torch.float32, device=dev)
    part_w = torch.empty_like(part_e)
    part_o = torch.empty((c, p), dtype=torch.int32, device=dev)
    energy = torch.empty(c, dtype=torch.float32, device=dev)
    virial = torch.empty_like(energy)
    params = _params(spec, c)
    tiles, epilogue = _entry_points()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = tiles(ctypes.byref(params), positions.data_ptr(),
                   part_e.data_ptr(), part_w.data_ptr(), part_o.data_ptr(),
                   stream)
        if rc != 0:
            raise RuntimeError(f"pair_tiles launch failed: cudaError {rc}")
        LAUNCHES += 1
        rc = epilogue(ctypes.byref(params), positions.data_ptr(),
                      part_e.data_ptr(), part_w.data_ptr(), part_o.data_ptr(),
                      energy.data_ptr(), virial.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"pair_epilogue launch failed: cudaError {rc}")
        LAUNCHES += 1
    return energy, virial


def total_energy_virial_plain(spec: SystemSpec, positions: torch.Tensor,
                              chunk_elems: int = 2 ** 28
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``total_energy_virial`` in chain chunks
    small enough that the (chunk, N, N, 2) pair tensor holds at most
    ``chunk_elems`` elements."""
    c, n = positions.shape[0], positions.shape[1]
    chunk = max(1, min(c, chunk_elems // max(n * n * 2, 1)))
    if chunk >= c:
        return total_energy_virial(spec, positions)
    parts = [total_energy_virial(spec, positions[i:i + chunk])
             for i in range(0, c, chunk)]
    return (torch.cat([e for e, _ in parts]),
            torch.cat([v for _, v in parts]))
