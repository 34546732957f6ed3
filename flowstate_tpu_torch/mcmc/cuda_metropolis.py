"""The Metropolis move loop as a hand-written CUDA kernel, and its plain
PyTorch version.

Port of ``flowstate_tpu/mcmc/pallas_metropolis.py``: ``run_moves_kernel``
is the counterpart of ``run_moves_pallas`` and launches
``csrc/metropolis_moves.cu`` (which replaces ``_move_kernel``);
``run_production_kernel`` of ``run_production_pallas``; ``run_moves_auto``
of ``run_moves_auto``.  ``run_moves_plain`` is the kernel's plain version,
with the same contract: state (and optional tables) in, state out, the
virial NaN until ``resync_energy``.

``run_moves_auto`` sends a CUDA tensor to the kernel and a CPU tensor to
the plain version; ``run_moves_kernel`` raises on anything it does not
take.  ``LAUNCHES`` counts the kernel's launches.  ``beta`` is one float
for every chain or a contiguous (C,) float32 tensor on the state's device,
each chain's own (parallel tempering runs every replica at its own beta in
one launch); a float passes a null table, so it adds no device work.

The kernel gives each chain a group of threads (``group_threads``: 4 or 8
lanes of a warp for N <= 16, a warp up to N = 256, a block of 128 or 256
threads above), keeps the chain for the whole launch where
``memory_path`` says (shared memory within 48 KB up to N = 5,888, opted-in
shared memory up to the card's maximum, 227 KB or N = 28,928 on an H100,
a device-memory scratch above) and reads and writes the state's own
tensors: a call is its checks, five ``torch.empty`` (six on the
device-memory path) and one launch, and leaves its input state untouched.
``group_threads``, ``memory_path``, ``launch_shape`` and
``particle_index`` mirror the CUDA source's launch arithmetic and its
division-free particle index for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from flowstate_tpu_torch.mcmc import metropolis
from flowstate_tpu_torch.mcmc.metropolis import Observables, Tables
from flowstate_tpu_torch.mcmc.state import ChainState, resync_energy
from flowstate_tpu_torch.ops.pair_energy import SystemSpec
from flowstate_tpu_torch.ops.potentials import well_centers
from flowstate_tpu_torch.utils.profiling import annotate

LAUNCHES = 0          # kernel launches in this process

Beta = Union[float, torch.Tensor]   # one beta, or (C,) float32 per chain


class _MoveParams(ctypes.Structure):
    """Mirror of ``MoveParams`` in ``csrc/metropolis_moves.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("num_chains", "n", "num_moves", "fast_math", "num_wells")] + [
        ("seed", ctypes.c_uint), ("calls", ctypes.c_uint),
        ("chain_offset", ctypes.c_uint)] + [
        (name, ctypes.c_float) for name in
        ("beta", "lx", "ly", "inv_lx", "inv_ly", "r_cut2", "hc2", "sigma2",
         "eps4", "shift", "wx0", "wy0", "wx1", "wy1", "v00", "v01", "r0", "k")]


# Threads per chain by particle count, as ``group_threads`` in the CUDA
# source: 4 up to GROUP4_MAX_N particles, 8 up to GROUP8_MAX_N, a warp up to
# WARP_MAX_N, 128 up to BLOCK128_MAX_N, 256 above.
GROUP4_MAX_N = 4
GROUP8_MAX_N = 16
WARP_MAX_N = 256
BLOCK128_MAX_N = 512
MAX_SHARED_BYTES = 48 * 1024  # a block's shared memory without opting in
# the most shared memory a block of an H100 may opt in to, as
# cudaDevAttrMaxSharedMemoryPerBlockOptin reads it; the kernel reads the
# card's own
H100_SHARED_OPTIN_BYTES = 232448
# where a chain's planes live, as kPath* in the CUDA source
PATH_SHARED, PATH_SHARED_OPT_IN, PATH_DEVICE = 0, 1, 2
PATH_NAMES = ("shared", "shared_opt_in", "device")


def group_threads(n: int) -> int:
    """Threads that own one chain of ``n`` particles in the move kernel."""
    if n < 1:
        raise ValueError(f"the move kernel takes 1 or more particles (got {n})")
    for limit, group in ((GROUP4_MAX_N, 4), (GROUP8_MAX_N, 8),
                         (WARP_MAX_N, 32), (BLOCK128_MAX_N, 128)):
        if n <= limit:
            return group
    return 256


def static_shared_bytes(group: int) -> int:
    """An instance's static shared memory: a float2 and an int per warp."""
    return max(group, 32) // 32 * 12


def plane_stride(n: int, group: int) -> int:
    """Floats per chain and plane: an odd multiple of the group."""
    stride = group * (-(-n // group) | 1)
    if 2 * stride > 2 ** 31 - 1:
        raise ValueError(f"the move kernel indexes a chain's planes in int32:"
                         f" {n} particles are past that")
    return stride


def memory_path(n: int, optin_bytes: int = H100_SHARED_OPTIN_BYTES) -> int:
    """Where a launch at ``n`` particles keeps its chains' planes, given
    the card's opt-in maximum: ``PATH_SHARED``, ``PATH_SHARED_OPT_IN`` or
    ``PATH_DEVICE``."""
    group = group_threads(n)
    chains = max(group, 32) // group
    nbytes = (2 * chains * plane_stride(n, group) * 4
              + static_shared_bytes(group))
    if nbytes <= MAX_SHARED_BYTES:
        return PATH_SHARED
    return PATH_SHARED_OPT_IN if nbytes <= optin_bytes else PATH_DEVICE


class LaunchShape(NamedTuple):
    """The move kernel's launch for ``num_chains`` chains of ``n``
    particles, as ``launch_moves`` in the CUDA source computes it."""

    group: int             # threads per chain
    block: int             # threads per block: a warp, or the group
    chains_per_block: int
    stride: int            # floats per chain and plane
    path: int              # PATH_SHARED, PATH_SHARED_OPT_IN or PATH_DEVICE
    shared_bytes: int      # dynamic shared memory (0 on the device path)
    scratch_floats: int    # device-memory planes (0 on a shared path)
    grid: int              # blocks


def launch_shape(n: int, num_chains: int,
                 optin_bytes: int = H100_SHARED_OPTIN_BYTES) -> LaunchShape:
    group = group_threads(n)
    block = max(group, 32)
    chains = block // group
    stride = plane_stride(n, group)
    grid = -(-num_chains // chains)
    path = memory_path(n, optin_bytes)
    planes = 2 * chains * stride
    on_device = path == PATH_DEVICE
    return LaunchShape(group, block, chains, stride, path,
                       0 if on_device else 4 * planes,
                       grid * planes if on_device else 0, grid)


def particle_index(bits, n: int):
    """``bits % n`` for uint32 ``bits`` (numpy), by the kernel's
    multiply-shift: with ``magic = (2**64 - 1) // n + 1`` (mod 2**64), the
    high 64 bits of ``(magic * bits mod 2**64) * n``."""
    magic = np.uint64(((2 ** 64 - 1) // n + 1) % 2 ** 64)
    low = magic * np.asarray(bits, dtype=np.uint64)      # wraps mod 2**64
    n64, half = np.uint64(n), np.uint64(32)
    # high word of the 96-bit product low * n, n < 2**32
    carry = ((low & np.uint64(0xFFFFFFFF)) * n64) >> half
    return (((low >> half) * n64 + carry) >> half).astype(np.int64)


def _library():
    from flowstate_tpu_torch.kernels import build

    return build.build().libs["metropolis_moves"]


def _entry_point():
    fn = _library().flowstate_metropolis_moves
    fn.argtypes = [ctypes.POINTER(_MoveParams)] + [ctypes.c_void_p] * 17
    fn.restype = ctypes.c_int
    return fn


def kernel_group_threads(n: int) -> int:
    """Threads per chain as the built kernel's own table gives them (0
    for n < 1); builds the kernels."""
    fn = _library().flowstate_metropolis_group_threads
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(n)


def kernel_memory_path(n: int) -> Tuple[int, int]:
    """``(path, optin_bytes)``: where the built kernel keeps the planes at
    ``n`` particles on the current card (-1 for n < 1) and the card's
    opt-in maximum it read; builds the kernels."""
    fn = _library().flowstate_metropolis_memory_path
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    optin = ctypes.c_int(0)
    path = fn(n, ctypes.byref(optin))
    return path, optin.value


@functools.lru_cache(maxsize=64)
def _scratch_floats(device_index: int, n: int, num_chains: int) -> int:
    """The device-memory planes a launch of ``num_chains`` chains of ``n``
    particles needs on card ``device_index`` (0 on a shared path), by the
    card's own opt-in maximum; cached, since a launch's host time is what
    bounds the main path's small calls."""
    with torch.cuda.device(device_index):
        optin = kernel_memory_path(1)[1]
    return launch_shape(n, num_chains, optin).scratch_floats


def kernel_division(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` by the move kernel's own branch-free division
    (``div_rn_normal`` in the CUDA source), for float32 CUDA tensors of one
    shape: to be held against ``a / b`` where ``b`` and the quotient are
    normal numbers."""
    _check("a", a, tuple(a.shape), torch.float32, a.device)
    _check("b", b, tuple(a.shape), torch.float32, a.device)
    if a.device.type != "cuda" or not 0 < a.numel() < 2 ** 31:
        raise ValueError("kernel_division takes non-empty CUDA tensors")
    q = torch.empty_like(a)
    fn = _library().flowstate_metropolis_division_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), a.numel(),
                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"division check launch failed: cudaError {rc}")
    return q


def _params(spec: SystemSpec, beta: float, state: ChainState,
            num_moves: int, fast_math: bool) -> _MoveParams:
    """The launch's parameters for ``state``'s chains: its seed, calls and
    chain offset key the randoms; ``beta`` is NaN when a (C,) table gives
    each chain its own."""
    lx, ly = spec.box.size_x, spec.box.size_y
    r_cut2 = spec.cutoff * spec.cutoff
    sr6_cut = (spec.sigma ** 2 / r_cut2) ** 3
    centers = well_centers(lx, ly, 2)
    v0 = list(spec.V0_list) + [0.0] * 2
    return _MoveParams(
        num_chains=state.positions.shape[0], n=spec.num_particles,
        num_moves=num_moves, fast_math=int(fast_math),
        num_wells=spec.num_wells, seed=state.seed & 0xFFFFFFFF,
        calls=state.calls & 0xFFFFFFFF,
        chain_offset=state.chain_offset & 0xFFFFFFFF,
        beta=beta, lx=lx, ly=ly, inv_lx=1.0 / lx, inv_ly=1.0 / ly,
        r_cut2=r_cut2, hc2=spec.hard_core * spec.hard_core,
        sigma2=spec.sigma ** 2, eps4=4.0 * spec.epsilon,
        shift=4.0 * spec.epsilon * (sr6_cut * sr6_cut - sr6_cut),
        wx0=centers[0][0], wy0=centers[0][1],
        wx1=centers[1][0], wy1=centers[1][1],
        v00=v0[0], v01=v0[1], r0=spec.r0, k=spec.k)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, positions on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(spec: SystemSpec, c: int, num_moves: int, device,
                  tables: Optional[Tables],
                  margin_log: Optional[torch.Tensor]) -> None:
    if tables is not None:
        p_tab, d_tab, u_tab = tables
        _check("p_tab", p_tab, (c, num_moves), torch.int32, device)
        _check("d_tab", d_tab, (c, num_moves, 2), torch.float32, device)
        _check("u_tab", u_tab, (c, num_moves), torch.float32, device)
        if p_tab.numel() and bool(((p_tab < 0)
                                   | (p_tab >= spec.num_particles)).any()):
            raise ValueError("p_tab holds particle indices outside [0, N)")
    if margin_log is not None:
        _check("margin_log", margin_log, (c, num_moves), torch.float32, device)


def _check_beta(beta: Beta, c: int, device) -> Optional[torch.Tensor]:
    """None for a float beta; a (C,) tensor checked against the state."""
    if isinstance(beta, torch.Tensor):
        _check("beta", beta, (c,), torch.float32, device)
        return beta
    return None


def run_moves_kernel(spec: SystemSpec, beta: Beta, state: ChainState,
                     num_moves: int, tables: Optional[Tables] = None,
                     margin_log: Optional[torch.Tensor] = None,
                     fast_math: bool = False) -> ChainState:
    """Advance every chain by ``num_moves`` moves in one kernel launch.

    The randoms come from Philox keyed on ``(state.seed,
    state.chain_offset + chain)`` (modulo 2^32) with counter ``(move,
    state.calls)``, so a shard of a run draws its chains' streams of the
    unsharded launch; or from ``tables`` =
    ``(p_tab, d_tab, u_tab)`` as ``metropolis.draw_tables`` makes them.
    ``margin_log`` (C, T) float32, if given, receives each move's
    ``exp(-beta dE) - u``.  ``beta`` is a float or each chain's, a (C,)
    float32 tensor.  The returned virial is NaN (not tracked);
    ``calls`` advances by one.  ``state``'s tensors are read, never written:
    the new state's are fresh.
    """
    global LAUNCHES
    pos = state.positions
    if pos.device.type != "cuda":
        raise ValueError(f"run_moves_kernel takes CUDA tensors, got {pos.device}"
                         "; run_moves_auto sends CPU tensors to run_moves_plain")
    n = spec.num_particles
    if num_moves < 0:
        raise ValueError(f"num_moves must be >= 0, got {num_moves}")
    c = pos.shape[0]
    dev = pos.device
    _check("positions", pos, (c, n, 2), torch.float32, dev)
    _check("energy", state.energy, (c,), torch.float32, dev)
    _check("max_disp", state.max_disp, (c,), torch.float32, dev)
    _check("virial", state.virial, (c,), torch.float32, dev)
    _check("accepts", state.accepts, (c,), torch.int32, dev)
    _check("attempts", state.attempts, (c,), torch.int32, dev)
    _check_tables(spec, c, num_moves, dev, tables, margin_log)
    beta_tab = _check_beta(beta, c, dev)
    if pos.data_ptr() % 8:
        raise ValueError("positions must be aligned to 8 bytes")
    scratch = _scratch_floats(dev.index, n, c)
    planes = (torch.empty(scratch, dtype=torch.float32, device=dev)
              if scratch else None)

    out = state.replace(
        positions=torch.empty_like(pos),
        energy=torch.empty_like(state.energy),
        virial=torch.empty_like(state.virial),
        accepts=torch.empty_like(state.accepts),
        attempts=torch.empty_like(state.attempts),
        calls=state.calls + 1,
    )
    params = _params(spec, float("nan") if beta_tab is not None else beta,
                     state, num_moves, fast_math)
    p_tab, d_tab, u_tab = tables if tables is not None else (None,) * 3
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _entry_point()
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(params), ptr(pos), ptr(state.energy),
                ptr(state.max_disp), ptr(state.accepts), ptr(state.attempts),
                ptr(out.positions), ptr(out.energy), ptr(out.accepts),
                ptr(out.attempts), ptr(out.virial), ptr(p_tab), ptr(d_tab),
                ptr(u_tab), ptr(margin_log), ptr(beta_tab), ptr(planes),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"metropolis_moves launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def run_moves_plain(spec: SystemSpec, beta: Beta, state: ChainState,
                    num_moves: int, tables: Optional[Tables] = None,
                    margin_log: Optional[torch.Tensor] = None) -> ChainState:
    """The kernel's plain PyTorch version (``metropolis.run_moves``), with
    the kernel's contract: the returned virial is NaN."""
    c = state.positions.shape[0]
    _check_tables(spec, c, num_moves, state.device, tables, margin_log)
    _check_beta(beta, c, state.device)
    out = metropolis.run_moves(spec, beta, state, num_moves, tables,
                               margin_log)
    return out.replace(virial=torch.full_like(out.virial, float("nan")))


def run_moves_auto(spec: SystemSpec, beta: Beta, state: ChainState,
                   num_moves: int) -> ChainState:
    """The kernel for a CUDA state, the plain version for a CPU state; a
    span ``mcmc.moves``."""
    with annotate("mcmc.moves"):
        if state.device.type == "cuda":
            return run_moves_kernel(spec, beta, state, num_moves)
        if state.device.type == "cpu":
            return run_moves_plain(spec, beta, state, num_moves)
    raise ValueError(f"no move engine for device {state.device}")


def run_production_kernel(spec: SystemSpec, beta: Beta, state: ChainState,
                          num_samples: int, sampling_frequency: int,
                          start_cycle: int = 0
                          ) -> Tuple[ChainState, Observables]:
    """Production: per block, ``sampling_frequency`` moves through
    ``run_moves_auto``, then ``resync_energy`` (exact energy, finite
    virial; on the card the pair-energy kernel), then one observable
    sample.  Leaves come back (C, T, ...)."""
    def move_fn(s: ChainState, num_moves: int) -> ChainState:
        return resync_energy(spec, run_moves_auto(spec, beta, s, num_moves))

    return metropolis.run_production_with(spec, beta, state, num_samples,
                                          sampling_frequency, move_fn,
                                          start_cycle)
