"""Particle-count scaling of the move kernel on the card, against a measured
fp32 roof.

Port of ``tools/n_scaling.py``.  ``calibrate_fp32_ops`` is the counterpart
of ``calibrate_vpu_ops``: it launches the issue-rate probe
``csrc/issue_rate.cu`` (which replaces that function's Pallas ``kernel``)
through ``issue_rate_kernel`` and returns the fp32 rate of each width,
counting an FMA as two operations; the fastest is the roof.  ``main`` times the move kernel K1 at N = 8 ...
1024 (each timed call is K1, then a resync through the pair-energy kernel
K2, as the JAX tool times the Pallas kernel and its resync), with and
without fast math, beside the plain engine, and reports each row's
fraction of the calibrated roof.

The op counts and peaks here are the ones ``chip_smoke.py`` computes its
kernels' bounds with.

    python -m flowstate_tpu_torch.tools.n_scaling             # on the card
    python -m flowstate_tpu_torch.tools.n_scaling --calibrate_only
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time
from typing import Dict, Sequence

import numpy as np
import torch

from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.initialise import initialise_fcc
from flowstate_tpu_torch.mcmc.state import init_chain_state, resync_energy
from flowstate_tpu_torch.ops import SystemSpec
from flowstate_tpu_torch.tools import common
# the H100's published peaks: fp32 outside the tensor cores, HBM3
from flowstate_tpu_torch.utils.roofs import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

# fp32 operations (an FMA counts two), read off the kernels' sources:
# K1, metropolis_moves.cu: a pair_term (two min images 10, r^2 3, max 1,
# division 1, powers 2, energy 4, sum 1), a well_term (two min images 10,
# r^2 3, sqrt 1, tanh argument 2, tanh 1, transition 2, depth 2, sum 1), a
# proposal with its wrap (14) and the decision (dE, -beta dE, exp, e += dE)
K1_PAIR_FLOPS, K1_WELL_FLOPS, K1_MOVE_FLOPS = 22, 22, 18
# K2, pair_energy.cu: the distance of every pair (two min images 10, r^2
# 3), the LJ terms of a pair inside the cutoff (max 1, division 1, sr6 2,
# sr12 1, energy 4, virial 4) and a particle's well term (22); a pair
# beyond the cutoff adds nothing and needs no LJ arithmetic
K2_DISTANCE_FLOPS, K2_LJ_FLOPS, K2_WELL_FLOPS = 13, 13, 22

TILE = (8, 128)                      # the TPU probe's one (8, 128) tile
# the n_acc template instances of csrc/issue_rate.cu and its one depth:
# the JAX tool's widths and depth
ISSUE_RATE_WIDTHS = (16, 32, 64, 128)
ISSUE_RATE_DEPTH = 8
# the calibration: (8, 128) tiles per SM, and timed calls per width
TILES_PER_SM, CALIBRATION_REPS = 4, 2
LAUNCHES = 0                         # issue-rate kernel launches
# the JAX tool's range of N (its Pallas kernel's cap, tools/n_scaling.py:
# 144); the port's K1 takes every N, the single run times it beyond
MAX_N = 1024


def bound_ms(flops: float, nbytes: float) -> tuple:
    """The least time the card could take, in ms, and what bounds it:
    ``flops`` at the fp32 peak against ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k1_ops_per_move(n: int, num_wells: int) -> int:
    """K1's fp32 operations for one move of one chain: the moved
    particle's old and new position against the other n - 1 and the
    wells, the proposal and the decision."""
    return (2 * (n - 1) * K1_PAIR_FLOPS + 2 * num_wells * K1_WELL_FLOPS
            + K1_MOVE_FLOPS)


def k1_bound(c: int, n: int, num_wells: int, moves: int) -> tuple:
    """K1's bound for ``moves`` moves of ``c`` chains of ``n`` particles;
    the chains' positions, energies, max displacements and accept counts
    are read and written once."""
    nbytes = c * (2 * n * 2 * 4 + 4 * 4)
    return bound_ms(c * moves * k1_ops_per_move(n, num_wells), nbytes)


def k2_bound(c: int, n: int, num_wells: int, pairs_inside=None) -> tuple:
    """K2's bound for a (c, n, 2) batch: the distance of every pair i < j,
    the LJ terms of the ``pairs_inside`` pairs within the cutoff (counted
    on the batch; None: every pair, the bound before the skip) and every
    particle's wells; positions read once, (energy, virial) written once."""
    pairs = c * (n * (n - 1) // 2)
    if pairs_inside is None:
        pairs_inside = pairs
    flops = (pairs * K2_DISTANCE_FLOPS + pairs_inside * K2_LJ_FLOPS
             + c * n * num_wells * K2_WELL_FLOPS)
    return bound_ms(flops, c * (n * 2 * 4 + 2 * 4))


def pairs_inside_cutoff(spec: SystemSpec, positions: torch.Tensor) -> int:
    """The pairs i < j of a (C, N, 2) batch within max(cutoff, hard core)
    of each other, by minimum image: the pairs whose LJ terms K2 computes,
    counted with torch on the batch's device, a few chains at a time."""
    from flowstate_tpu_torch.ops.box import min_image, squared_norm

    c, n = positions.shape[0], positions.shape[1]
    reach2 = max(spec.cutoff, spec.hard_core) ** 2
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                  device=positions.device), diagonal=1)
    chunk = max(1, 2 ** 24 // max(n * n, 1))
    total = 0
    for i in range(0, c, chunk):
        p = positions[i:i + chunk]
        sq = squared_norm(min_image(p[:, :, None, :] - p[:, None, :, :],
                                    spec.box))
        total += int(((sq <= reach2) & upper).sum())
    return total


def k3_ops(num_elems: int, n_acc: int, depth: int, iters: int) -> int:
    """The probe's fp32 operations, as the JAX tool counts them: a
    multiply and an add per step of each chain of each element."""
    return 2 * n_acc * depth * iters * num_elems


def k3_bound(num_elems: int, n_acc: int, depth: int, iters: int) -> tuple:
    """K3's bound: its operations against one read and one write of each
    float32 element."""
    return bound_ms(k3_ops(num_elems, n_acc, depth, iters), 8 * num_elems)


# --------------------------------------------------------------------------
# K3: the fp32 issue-rate probe

def _entry_point():
    from flowstate_tpu_torch.kernels import build

    fn = build.build().libs["issue_rate"].flowstate_issue_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_probe(x: torch.Tensor, n_acc: int, depth: int, iters: int) -> None:
    if x.ndim != 3 or tuple(x.shape[1:]) != TILE or x.shape[0] < 1:
        raise ValueError(f"x must be (B, 8, 128) with B >= 1, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x holds {x.numel()} elements; the kernel takes "
                         f"fewer than 2**31")
    if n_acc < 1 or depth < 1:
        raise ValueError(f"n_acc and depth must be positive, got {n_acc}, "
                         f"{depth}")
    if not 0 <= iters < 2 ** 31:
        raise ValueError(f"iters must be in [0, 2**31), got {iters}")


def _check_instance(n_acc: int, depth: int) -> None:
    """The kernel runs only its compiled widths and depth."""
    if n_acc not in ISSUE_RATE_WIDTHS:
        raise ValueError(f"n_acc must be one of {ISSUE_RATE_WIDTHS} on the "
                         f"card, got {n_acc}")
    if depth != ISSUE_RATE_DEPTH:
        raise ValueError(f"depth must be {ISSUE_RATE_DEPTH} on the card, got "
                         f"{depth}")


def issue_rate_kernel(x: torch.Tensor, n_acc: int, depth: int,
                      iters: int) -> torch.Tensor:
    """The probe on a (B, 8, 128) float32 tensor: one launch of the CUDA
    kernel on the current stream for a CUDA tensor, the plain version (any
    width and depth) for a CPU tensor; any other device, shape or type, or
    on the card a width or depth not compiled, raises before anything is
    built or launched."""
    global LAUNCHES
    _check_probe(x, n_acc, depth, iters)
    if x.device.type == "cpu":
        return issue_rate_plain(x, n_acc, depth, iters)
    if x.device.type != "cuda":
        raise ValueError(f"issue_rate_kernel takes CUDA or CPU tensors, got "
                         f"{x.device}")
    _check_instance(n_acc, depth)
    out = torch.empty_like(x)
    fn = _entry_point()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), n_acc, depth, iters,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"issue_rate launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def issue_rate_plain(x: torch.Tensor, n_acc: int, depth: int, iters: int,
                     fused: bool = False) -> torch.Tensor:
    """The probe's plain PyTorch version, on any shape: the accumulators
    are one (n_acc, ...) tensor, each step a multiply by the (n_acc, 1, ...)
    vector c and an add, rounded separately as the TPU kernel's.  With
    ``fused``, each step rounds once, as the CUDA kernel's FFMA: the
    product of two float32 is exact in float64, so the step is computed
    there and rounded to float32 (equal to an FMA but where rounding
    twice lands on a float32 tie)."""
    shape = (n_acc,) + (1,) * x.ndim
    acc = x.unsqueeze(0) + torch.arange(n_acc, dtype=torch.float32,
                                        device=x.device).view(shape)
    c = torch.tensor([float(np.float32(1.0 + 1e-7 * (i + 1)))
                      for i in range(n_acc)], dtype=torch.float32,
                     device=x.device).view(shape)
    if fused:
        c64, add = c.double(), float(np.float32(1e-7))
        for _ in range(iters * depth):
            acc = (acc.double() * c64 + add).float()
    else:
        for _ in range(iters * depth):
            acc.mul_(c).add_(1e-7)
    out = acc[0].clone()
    for i in range(1, n_acc):
        out += acc[i]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_fp32_ops(iters: int = 65536, depth: int = ISSUE_RATE_DEPTH,
                       widths: Sequence[int] = ISSUE_RATE_WIDTHS,
                       device="cuda") -> Dict[int, float]:
    """fp32 operations per second of the probe at each width (an FMA
    counts two, as ``K1_PAIR_FLOPS`` and the rest do); the highest is the
    card's roof.  On ``TILES_PER_SM`` (8, 128) tiles per SM (one tile on
    the CPU): one warm-up call, then ``CALIBRATION_REPS`` calls, each fed
    the last one's output as the JAX tool does, timed by CUDA events on
    the card.  Prints one JSON line per width."""
    device = torch.device(device)
    tiles = (TILES_PER_SM * torch.cuda.get_device_properties(device)
             .multi_processor_count if device.type == "cuda" else 1)
    x = torch.ones((tiles,) + TILE, dtype=torch.float32, device=device)
    rates = {}
    for n_acc in widths:
        y = issue_rate_kernel(x, n_acc, depth, iters)
        _sync(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALIBRATION_REPS):
                y = issue_rate_kernel(y, n_acc, depth, iters)
            end.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(end) / 1e3 / CALIBRATION_REPS
        else:
            t0 = time.perf_counter()
            for _ in range(CALIBRATION_REPS):
                y = issue_rate_kernel(y, n_acc, depth, iters)
            seconds = (time.perf_counter() - t0) / CALIBRATION_REPS
        rates[n_acc] = k3_ops(x.numel(), n_acc, depth, iters) / seconds
        print(json.dumps({"calibrate_n_acc": n_acc, "ops_per_s": rates[n_acc],
                          "ms": seconds * 1e3, "tiles": tiles,
                          "device": device.type}), flush=True)
    return rates


# --------------------------------------------------------------------------
# K1 against N

def c_blk(rows: int) -> int:
    """Chains per block of the JAX tool's rule (``_pick_c_blk``): 512 while
    the padded particle rows are shallow, 128 beyond 32 rows.  It sets the
    chain count of a row (``chains_for``) and says nothing of the port's
    launch: K1 gives each chain ``cuda_metropolis.group_threads(n)``
    threads, the row's ``threads_per_chain``."""
    return 512 if rows <= 32 else 128


def chains_for(n: int) -> int:
    """The JAX tool's chain count for N particles: at least four blocks,
    and about 49,152 particles in all, in multiples of 128 chains."""
    rows = (n + 7) // 8 * 8
    return max(4 * c_blk(rows), (49152 // n + 127) // 128 * 128)


def time_engine(fn, state, repeats: int, device: torch.device) -> float:
    """Seconds per call of ``fn(state) -> state`` after two warm calls,
    by the host clock between synchronisations."""
    out = fn(fn(state))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(out)
    _sync(device)
    return (time.perf_counter() - t0) / repeats


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", type=int, nargs="+",
                    default=[8, 32, 128, 512, 1024])
    ap.add_argument("--rho", type=float, default=0.3)
    ap.add_argument("--moves", type=int, default=8192)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--plain_moves", type=int, default=16,
                    help="moves per timed call of the plain engine")
    ap.add_argument("--out", default="results/n_scaling_torch.json")
    ap.add_argument("--no_calibrate", action="store_true")
    ap.add_argument("--calibrate_only", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda or cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    outside = [n for n in args.ns if not 2 <= n <= MAX_N]
    if outside:
        raise ValueError(f"--ns must lie in [2, {MAX_N}], got {outside}")
    on_card = device.type == "cuda"

    fp32_ops_per_s = None
    if not args.no_calibrate:
        fp32_ops_per_s = max(calibrate_fp32_ops(device=device).values())
        print(json.dumps({"fp32_ops_per_s": fp32_ops_per_s,
                          "of_peak": fp32_ops_per_s / PEAK_FP32_FLOPS}),
              flush=True)
    result = {"device": common.card_fields(device),
              "fp32_ops_per_s": fp32_ops_per_s,
              "fp32_peak": PEAK_FP32_FLOPS,
              "engine": ("K1 (csrc/metropolis_moves.cu), then a resync "
                         "through K2 (csrc/pair_energy.cu)" if on_card else
                         "the plain engine on the CPU (no kernel)"),
              "ops_per_move_model": f"2 (n - 1) {K1_PAIR_FLOPS} + "
                                    f"{K1_MOVE_FLOPS}",
              "rows": []}
    if args.calibrate_only:
        return result

    def kernel_moves(spec, moves, fast_math):
        def step(s):
            if on_card:
                s = cm.run_moves_kernel(spec, 1.0, s, moves,
                                        fast_math=fast_math)
            else:
                s = cm.run_moves_plain(spec, 1.0, s, moves)
            return resync_energy(spec, s)
        return step

    for n in args.ns:
        pos, box = initialise_fcc(n, args.rho, 1.0)
        spec = SystemSpec.create(n, box, num_wells=0)
        chains = chains_for(n)
        positions = torch.as_tensor(
            np.broadcast_to(pos, (chains, n, 2)).copy(), device=device)
        state = init_chain_state(spec, positions, 0)
        # brief equilibration off the lattice, through the move kernel
        state = resync_energy(spec, cm.run_moves_auto(spec, 1.0, state, 512))
        _sync(device)

        moves = args.moves * max(1, 256 // n)
        t_plain = time_engine(
            lambda s: cm.run_moves_plain(spec, 1.0, s, args.plain_moves),
            state, args.repeats, device)
        t_kernel = time_engine(kernel_moves(spec, moves, False), state,
                               args.repeats, device)
        t_fast = time_engine(kernel_moves(spec, moves, True), state,
                             args.repeats, device)
        plain_rate = chains * args.plain_moves / t_plain
        row = {
            "n": n, "chains": chains, "c_blk": c_blk((n + 7) // 8 * 8),
            "threads_per_chain": cm.group_threads(n),
            "moves_per_call": moves, "plain_moves_per_call": args.plain_moves,
            "plain_moves_per_s": plain_rate,
            "kernel_moves_per_s": chains * moves / t_kernel,
            "kernel_fast_moves_per_s": chains * moves / t_fast,
        }
        row["speedup"] = row["kernel_moves_per_s"] / plain_rate  # per move
        best = max(row["kernel_moves_per_s"], row["kernel_fast_moves_per_s"])
        row["ops_per_move"] = k1_ops_per_move(n, 0)
        # pair rows swept per second: moves/s falls as 1/N because each
        # move's energy is O(N) physics; the row rate separates that from
        # the kernel's efficiency
        row["row_elems_per_s"] = (n - 1) * best
        if fp32_ops_per_s:
            row["frac_of_roof"] = row["ops_per_move"] * best / fp32_ops_per_s
        result["rows"].append(row)
        print(json.dumps(row), flush=True)

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)

    print(f"\n{result['device']['name']}, {result['device']['power_limit']}"
          f"; fp32 roof {fp32_ops_per_s} ops/s\n")
    print("| N | chains | threads per chain | plain moves/s | K1 moves/s | "
          "fast-math | speedup | pair rows/s | frac of fp32 roof |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in result["rows"]:
        print(f"| {r['n']} | {r['chains']} | {r['threads_per_chain']} "
              f"| {r['plain_moves_per_s']:.4g} "
              f"| {r['kernel_moves_per_s']:.4g} "
              f"| {r['kernel_fast_moves_per_s']:.4g} "
              f"| {r['speedup']:.4g}x "
              f"| {r['row_elems_per_s']:.4g} "
              f"| {r.get('frac_of_roof', float('nan')):.4g} |")
    return result


if __name__ == "__main__":
    main()
