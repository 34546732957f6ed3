"""Total energy and virial of a batch of configurations: the hand-written
CUDA kernel and its plain PyTorch version.

Port of ``flowstate_tpu/ops/pallas_pair.py``: ``total_energy_virial_kernel``
is the counterpart of ``total_energy_virial_pallas`` and launches
``csrc/pair_energy.cu`` (which replaces ``_pair_tile_kernel``), batched over
chains: a (C, N, 2) float32 CUDA batch in, (energy, virial) of shape (C,)
out, with any hard-core overlap mapped to (+inf, +inf).  A call is its
checks, one ``torch.empty`` and one launch; ``LAUNCHES`` counts launches.
``total_energy_virial_plain`` is its plain version: ``total_energy_virial``
in chain chunks.

The kernel gives each chain a group of 4, 8 or 32 lanes (N <= 32) or a
cluster of blocks, and splits the chain's pairs over them by a circulant
rule.  ``group_threads``, ``split``, ``launch_shape`` and ``thread_pairs``
mirror the CUDA source's launch arithmetic and pair rule for the CPU tests;
``kernel_launch_shape`` reads the built kernel's own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from flowstate_tpu_torch.ops.pair_energy import SystemSpec, total_energy_virial
from flowstate_tpu_torch.ops.potentials import well_centers

LAUNCHES = 0      # kernel launches in this process (one per call)

# The launch arithmetic of csrc/pair_energy.cu, constant for constant:
# lanes per chain 4 up to GROUP4_MAX_N particles, 8 up to GROUP8_MAX_N, a
# warp up to WARP_MAX_N; above, clusters of up to MAX_CLUSTER blocks of
# BLOCK threads, BLOCKS_PER_SM of them per SM, the chain staged in shared
# memory up to MAX_STAGED_BYTES.
GROUP4_MAX_N = 4
GROUP8_MAX_N = 16
WARP_MAX_N = 32
BLOCK = 256
BLOCKS_PER_SM = 4
MAX_CLUSTER = 8
FIXED_TURNS = 8
MAX_STAGED_BYTES = 52 * 1024


class _PairParams(ctypes.Structure):
    """Mirror of ``PairParams`` in ``csrc/pair_energy.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("num_chains", "n", "num_wells", "num_sms")] + [
        (name, ctypes.c_float) for name in
        ("lx", "ly", "inv_lx", "inv_ly", "r_cut2", "hc2", "sigma2", "eps4",
         "eps48", "shift", "wx0", "wy0", "wx1", "wy1", "v00", "v01", "r0",
         "k")]


class LaunchShape(NamedTuple):
    """The kernel's launch for C chains of n particles, as
    ``launch_shape`` in the CUDA source computes it."""

    threads: int        # threads per chain
    cluster: int        # blocks per chain; 0 for a group of lanes
    blocks: int         # grid
    block: int          # threads per block
    segments: int       # m: parts of a row's offsets
    seg_len: int        # kseg: offsets per part, a unit's turns
    units: int          # units per thread
    shared_bytes: int   # the staged chain; 0: read from device memory


def group_threads(n: int) -> int:
    """Lanes per chain for n <= WARP_MAX_N."""
    return 4 if n <= GROUP4_MAX_N else 8 if n <= GROUP8_MAX_N else 32


def split(n: int, threads: int) -> Tuple[int, int, int]:
    """The circulant split of a chain's pairs over ``threads`` threads:
    (m parts per row, kseg offsets per part, units per thread)."""
    kmax = n // 2
    m = max(1, min(threads // n, kmax))
    kseg = -(-kmax // m)
    return m, kseg, -(-n * m // threads)


def launch_shape(n: int, c: int, num_sms: int) -> LaunchShape:
    if n < 1 or c < 1 or num_sms < 1:
        raise ValueError(f"no launch for N={n}, C={c} on {num_sms} SMs")
    if n <= WARP_MAX_N:
        g = group_threads(n)
        return LaunchShape(g, 0, -(-c // (32 // g)), 32, *split(n, g), 0)
    slots = num_sms * BLOCKS_PER_SM
    costs = []
    for s in range(1, MAX_CLUSTER + 1):
        _, kseg, units = split(n, s * BLOCK)
        costs.append(-(-c * s // slots) * (units * kseg + FIXED_TURNS))
    s = costs.index(min(costs)) + 1               # the smallest of the best
    m, kseg, units = split(n, s * BLOCK)
    staged = (n + n // 2 + m) * 8
    return LaunchShape(s * BLOCK, s, c * s, BLOCK, m, kseg, units,
                       staged if staged <= MAX_STAGED_BYTES else 0)


def thread_pairs(n: int, threads: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every pair (i, j) of a chain of ``n`` particles with the thread of
    the chain's ``threads`` that sums it, by the kernel's rule: unit u < n m
    is row i = u mod n, part s = u // n of thread u mod threads, and
    holds offsets k = s kseg + 1 ... up to the row's length (floor((n - 1)
    / 2), or n / 2 in the rows i < n / 2 of an even n), j = (i + k) mod n.
    Returns int32 arrays (thread, i, j); the pairs of one thread appear in
    the order it sums them."""
    m, kseg, _ = split(n, threads)
    kmax = n // 2
    u = np.arange(n * m, dtype=np.int32)
    i, s = u % n, u // n
    length = np.where((n % 2 == 1) | (i < kmax), kmax, kmax - 1)
    k = s[:, None] * kseg + np.arange(1, kseg + 1, dtype=np.int32)
    ok = k <= length[:, None]
    rows = np.broadcast_to(i[:, None], k.shape)[ok]
    return (np.broadcast_to((u % threads)[:, None], k.shape)[ok], rows,
            (rows + k[ok]) % n)


@functools.lru_cache(maxsize=None)
def _params(spec: SystemSpec, num_chains: int, num_sms: int) -> _PairParams:
    """The kernel's parameters, made once per (spec, C, SM count)."""
    lx, ly = spec.box.size_x, spec.box.size_y
    r_cut2 = spec.cutoff * spec.cutoff
    sr6_cut = (spec.sigma ** 2 / r_cut2) ** 3
    centers = well_centers(lx, ly, 2)
    v0 = list(spec.V0_list) + [0.0] * 2
    return _PairParams(
        num_chains=num_chains, n=spec.num_particles,
        num_wells=spec.num_wells, num_sms=num_sms,
        lx=lx, ly=ly, inv_lx=1.0 / lx, inv_ly=1.0 / ly,
        r_cut2=r_cut2, hc2=spec.hard_core * spec.hard_core,
        sigma2=spec.sigma ** 2, eps4=4.0 * spec.epsilon,
        eps48=48.0 * spec.epsilon,
        shift=4.0 * spec.epsilon * (sr6_cut * sr6_cut - sr6_cut),
        wx0=centers[0][0], wy0=centers[0][1],
        wx1=centers[1][0], wy1=centers[1][1],
        v00=v0[0], v01=v0[1], r0=spec.r0, k=spec.k)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    from flowstate_tpu_torch.kernels import build

    return build.build().libs["pair_energy"]


_ENTRY = None     # the bound entry point, set at the first launch


def _launch(params: _PairParams, positions: torch.Tensor, out: torch.Tensor,
            stream: int) -> None:
    """One launch of the kernel on ``stream``: ``positions`` in, ``out``
    (2, C) written; raises if the launch returns a cudaError."""
    global LAUNCHES, _ENTRY
    if _ENTRY is None:
        fn = _library().flowstate_pair_energy
        fn.argtypes = [ctypes.POINTER(_PairParams)] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _ENTRY = fn
    rc = _ENTRY(ctypes.byref(params), positions.data_ptr(), out.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"pair_energy launch failed: cudaError {rc}")
    LAUNCHES += 1


def kernel_launch_shape(n: int, c: int, num_sms: int) -> LaunchShape:
    """The launch as the built kernel's own table gives it; builds the
    kernels."""
    fn = _library().flowstate_pair_launch_shape
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    fields = (ctypes.c_int * 8)()
    rc = fn(n, c, num_sms, fields)
    if rc != 0:
        raise ValueError(f"the kernel takes no launch for N={n}, C={c}: "
                         f"cudaError {rc}")
    return LaunchShape(*fields)


def _check_positions(spec: SystemSpec, positions: torch.Tensor) -> None:
    """Raise unless ``positions`` is a contiguous, 8-byte aligned
    (C, N, 2) float32 batch with C >= 1 and N >= 1."""
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


def total_energy_virial_kernel(spec: SystemSpec, positions: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy and virial, (C,) float32 each (the two rows of one (2, C)
    tensor), of every configuration of a (C, N, 2) float32 CUDA batch, in
    one launch on the current stream."""
    _check_positions(spec, positions)
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError("total_energy_virial_kernel takes CUDA tensors, got "
                         f"{dev}; total_energy_virial_plain takes CPU "
                         "tensors")
    c = positions.shape[0]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(index):
        _launch(_params(spec, c, _num_sms(index)), positions, out,
                torch.cuda.current_stream(index).cuda_stream)
    return out[0], out[1]


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
