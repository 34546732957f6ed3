#!/usr/bin/env python3
"""Drive the PyTorch port (``flowstate_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``flowstate_tpu_torch/csrc``
(the Metropolis move kernel K1, the pair-energy kernel K2 and the fp32
issue-rate probe K3, one ``nvcc`` each, in parallel), holds each against
its plain PyTorch version (K1 from N=3 to 32,768, on each of its memory
paths), checks K1's statistics and the exact N=1 free
energy, runs the MCMC-only experiment at the reference preset through K1
and K2, times them, runs the NVT single-run CLI at N=1024, 2048 and
8192, reads the
card's fp32 roof with K3, runs the N-scaling tool and the parameter sweep
with its locked CSV fan-in, checks and times Algorithm 1's flow at full
width (K=15, hidden 256, 32 bins), runs Algorithm 1 end to end
(equilibration and sample collection on K1 and K2, training, big moves
whose proposal energies go through K2), and runs Algorithm 2 at the
reference's full width (100 chains, K=23, hidden 128, 15 bins): the host
loop, a resume from its checkpoint, the fused runner frozen half way, and
the mixed (reverse-KLD) loss, runs the blocked moves, and runs the other
samplers: K1 with a beta per chain, TEMPERING.md's parallel-tempering run
(256 walkers x 10 replicas, 3000 rounds) through the tempering driver
with a resume, MALA and HMC, and the NPZ trainer, and runs the
transformer and the gnn conditioner nets at N=8 at full width, with
Algorithm 1 through each, and the residual flow in bf16 and unstacked,
runs the multi-device layer: K1 in shards at their chain offsets
against one launch, the eight-step dry run over NCCL at world size 1, and
the data-parallel step against the single one, runs the dense flow zoo
(phase 19: the circular autoregressive spline as Algorithm 1's big-move
proposal through K1 and K2, normflows' RealNVP and neural-spline examples,
HAIS), and runs the image, residual and Lipschitz flows (phase 20:
normflows' Glow example at full width, L = 3, K = 16, hidden 256, 3 x 32
x 32 at batch 128, trained and timed, with one step timed with TF32
allowed; its residual-flow example with the Lipschitz update; the
induced-norm layers against closed forms and dense operators; the
convolutions' float32 first and second derivatives against float64),
and runs the gate and sampler tools and the demos (phase 21: the
quadrature behind 1.490 through K2 at 4e6 configurations against its
float64 plain version and the exact values, ``move_kernel_check``'s
statistics of K1 at 16,384 chains, ``ess_check``, ``sampler_bench``,
``within_well_bench`` and ``pt_mbar_oracle`` at cut sizes, the five
demos, and the host-bound share of a MALA and a hybrid round), and runs
the N-scaling studies at cut sizes and full widths (phase 22:
``hybrid_n_scaling`` at N = 8 and 16 with Algorithm 1's flow,
``n_mitigation``'s base, transformer and gnn rungs, ``blocked_wall`` and
``blocked_depth`` with the blocked flow at K = 4 and 10 and the latter's
16,384-chain throughput segment, ``alpha_study`` at alpha 1 and 0.5 on
Algorithm 2's preset).
Each phase prints one line with its name,
PASS and its numbers; any failure raises and the script exits non-zero.
The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero at once and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# Near-tie rule: an accept decision may differ between two versions only
# where |exp(-beta dE) - u| is below this (float rounding of dE).
NEAR_TIE = 1e-5
POS_ATOL = 1e-5
E_RTOL, E_ATOL = 1e-5, 1e-3
# K2 against its plain version: |d| <= PAIR_RTOL * (sum of |terms|) +
# PAIR_ATOL.  The two sum up to 8.4e6 pair terms per chain in different
# orders (a thread adds up to 256 terms in sequence, then a fixed tree;
# PyTorch reduces in its own blocks), and round the LJ powers through a
# division of r^2 against a sqrt: float32 rounding of order 1e-7 per term
# and at most ~1.5e-5 of the sum of magnitudes for 256 sequential adds.
PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-4

# K3 against its plain version with FFMA rounding (``fused``), relative to
# the output: the two differ only where rounding a step twice (float64,
# then float32) lands on a float32 tie, about one output ulp (6e-8) at
# most.  At the check's inputs the loop moves the output by 2.3e-3
# relative at n_acc 16, so this tolerance is 4e-4 of the loop's effect.
K3_RTOL = 1e-6
# against the plain version that rounds the multiply and the add apart, as
# the TPU kernel does: over iters x depth = 2048 steps the two roundings
# part by 5.8e-5 relative at the check's inputs (a float64 simulation)
K3_UNFUSED_RTOL = 1e-4
# the K3 check's size: B tiles of (8, 128), depth, iters, at every width
K3_CHECK = dict(depth=8, iters=256)


def phase(name: str, **numbers) -> None:
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{name}] PASS {fields}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current stream, by CUDA
    events over ``reps`` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reference_spec(n: int = 3):
    from flowstate_tpu_torch.tools.common import double_well_spec

    return double_well_spec(n)


def phase_device() -> str:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = out.splitlines()[0]
    phase("1 device", cuda_devices=torch.cuda.device_count())
    print(card, flush=True)
    return card


def phase_build() -> float:
    from flowstate_tpu_torch.kernels import build

    res = build.build()
    for line in res.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    require(set(res.libs) == {"metropolis_moves", "pair_energy",
                              "issue_rate"},
            f"built {sorted(res.libs)}")
    phase("2 build", seconds=f"{res.seconds:.2f}",
          libraries=",".join(sorted(res.paths.values())))
    return res.seconds


def compare_pathwise(spec, state, num_moves: int, seed: int, label: str,
                     beta: float = 1.0, fast_math: bool = False) -> float:
    """Kernel and plain version on the same injected tables; returns the
    largest absolute difference over positions and energies."""
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.metropolis import draw_tables

    c = state.positions.shape[0]
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    tables = draw_tables(spec, c, num_moves, g, DEVICE)
    mk = torch.empty((c, num_moves), device=DEVICE)
    mp = torch.empty_like(mk)
    out_k = cm.run_moves_kernel(spec, beta, state, num_moves, tables, mk,
                                fast_math)
    out_p = cm.run_moves_plain(spec, beta, state, num_moves, tables, mp)
    torch.cuda.synchronize()

    dk, dp = mk > 0, mp > 0
    # the kernel's decisions are exactly its margins' signs
    require(bool(((out_k.accepts - state.accepts)
                  == dk.sum(1).to(torch.int32)).all()),
            f"{label}: accept count != positive margins")
    differ = dk != dp
    split = differ.any(dim=1)
    first = differ.to(torch.int32).argmax(dim=1)
    rows = torch.nonzero(split).flatten()
    tie = mp[rows, first[rows]].abs()
    require(bool((tie < NEAR_TIE).all()),
            f"{label}: decisions differ away from a tie: margins "
            f"{tie[tie >= NEAR_TIE][:5].tolist()}")
    require(int(split.sum()) <= max(1, c // 100),
            f"{label}: {int(split.sum())} chains split at near ties")
    keep = ~split
    pos_err = float((out_k.positions - out_p.positions)[keep].abs().max())
    e_err = (out_k.energy - out_p.energy)[keep].abs()
    require(pos_err <= POS_ATOL, f"{label}: positions differ by {pos_err}")
    require(bool((e_err <= E_ATOL + E_RTOL * out_p.energy[keep].abs()).all()),
            f"{label}: energies differ by {float(e_err.max())}")
    require(bool(torch.isnan(out_k.virial).all()), f"{label}: virial not NaN")
    acc = float(dk.float().mean())
    print(f"  {label}: C={c} T={num_moves} acceptance={acc:.4f} "
          f"split_at_ties={int(split.sum())} pos_err={pos_err:.3g} "
          f"e_err={float(e_err.max()):.3g}", flush=True)
    return max(pos_err, float(e_err.max()))


# K1 above the old cap of 1024 particles: (N, chains, moves) on the 48 KB,
# the opted-in and the device-memory path
K1_WIDE_CHECKS = ((2048, 16, 32), (8192, 8, 16), (32768, 4, 8))
# the paths' edges on an H100 (227 KB a block), where the mirror and the
# kernel's own table are compared beside N = 1 ... 1024
K1_PATH_EDGES = [2048, 5888, 5889, 8192, 28928, 28929, 32768, 40000]


def phase_pathwise() -> float:
    import torch

    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS, init_chain_state
    from flowstate_tpu_torch.ops import SystemSpec

    def wells_state(n, c, seed):
        pos, _ = init_alternating_wells(c, n, 0.03)
        return init_chain_state(reference_spec(n),
                                torch.as_tensor(pos, device=DEVICE), seed, 0.65)

    errs = []
    spec3 = reference_spec(3)
    errs.append(compare_pathwise(spec3, wells_state(3, 100, 1), 150, 11,
                                 "N=3 main-path shape"))
    errs.append(compare_pathwise(spec3, wells_state(3, 1000, 2), 256, 12,
                                 "N=3 C=1000"))
    errs.append(compare_pathwise(spec3, wells_state(3, 1000, 2), 256, 12,
                                 "N=3 C=1000 fast_math", fast_math=True))
    for fast in (False, True):
        errs.append(compare_pathwise(
            reference_spec(12), wells_state(12, 1000, 3), 256, 13,
            "N=12" + " fast_math" * fast, fast_math=fast))

    # every group size and its edges: 8 lanes (N=12 above, N=16), a warp
    # (N=17, 32 with two wells, 33, 128, 200, 256), a block of 128 (N=257,
    # 512) and of 256 (N=1024, the single-run CLI's size); chain counts
    # that leave the last warp of 8-lane groups partly idle; exact and
    # fast math
    def lattice_state(n, c, seed, max_disp, wells=0):
        pos, box = jittered_lattices(n, c, seed)
        spec = SystemSpec.create(n, box, num_wells=wells,
                                 V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
        return spec, init_chain_state(spec, pos, seed, max_disp)

    for n, c, moves, max_disp, wells in (
            (16, 130, 256, 2.0, 2), (17, 100, 256, 2.0, 2),
            (32, 130, 256, 2.0, 2), (33, 100, 128, 3.0, 0),
            (128, 256, 256, 3.0, 0), (128, 130, 128, 3.0, 0),
            (200, 64, 128, 3.0, 0), (256, 64, 128, 3.0, 0),
            (257, 64, 128, 3.0, 0), (512, 64, 64, 3.0, 0),
            (1024, 128, 64, 3.0, 0)):
        spec_n, s_n = lattice_state(n, c, n + c, max_disp, wells)
        for fast in (False, True):
            errs.append(compare_pathwise(
                spec_n, s_n, moves, n, f"N={n} wells={wells}"
                + " fast_math" * fast, fast_math=fast))
    # every N the reference takes (F10): 256 threads a chain, the planes
    # in 48 KB of shared memory (N=2048), in opted-in shared memory
    # (N=8192) and in a device-memory scratch (N=32,768); few chains and
    # moves, since the plain version's move is a sweep over N
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm

    from flowstate_tpu_torch.tools.n_scaling import k1_bound

    optin = cm.kernel_memory_path(1)[1]
    paths = {}
    for n, c, moves in K1_WIDE_CHECKS:
        spec_n, s_n = lattice_state(n, c, n + c, 3.0)
        path = cm.memory_path(n, optin)
        paths[n] = cm.PATH_NAMES[path]
        errs.append(compare_pathwise(spec_n, s_n, moves, n,
                                     f"N={n} {paths[n]} path"))

        def launch():
            return cm.run_moves_kernel(spec_n, 1.0, s_n, moves)

        bound_ms, bound_by = k1_bound(c, n, 0, moves)
        print(f"  N={n} {paths[n]} path: K1 {cuda_ms(launch, 5):.4f} ms a "
              f"launch of {c} x {moves}, bound {bound_ms:.4g} ms "
              f"({bound_by})", flush=True)
        one_kernel_per_call(launch, 20, "metropolis_moves_kernel",
                            f"run_moves_kernel at N={n}", at_least_one=True)
    require([paths[n] for n, _, _ in K1_WIDE_CHECKS]
            == ["shared", "shared_opt_in", "device"],
            f"K1's memory paths at {[n for n, _, _ in K1_WIDE_CHECKS]}: "
            f"{paths}")
    err = max(errs)

    # Philox: the same state and seed reproduce bit for bit; the next
    # launch (calls + 1) and another seed draw fresh streams
    s = wells_state(3, 1000, 5)
    before = {f: getattr(s, f).clone() for f in TENSOR_FIELDS}
    a = cm.run_moves_kernel(spec3, 1.0, s, 256)
    b = cm.run_moves_kernel(spec3, 1.0, s, 256)
    nxt = cm.run_moves_kernel(spec3, 1.0, a.replace(positions=s.positions,
                                                    energy=s.energy), 256)
    other = cm.run_moves_kernel(spec3, 1.0, s.replace(seed=6), 256)
    require(torch.equal(a.positions, b.positions)
            and torch.equal(a.accepts, b.accepts), "Philox not reproducible")
    require(a.calls == s.calls + 1, "calls did not advance")
    require(not torch.equal(a.positions, nxt.positions)
            and not torch.equal(a.positions, other.positions),
            "Philox stream replayed across launches or seeds")
    # a launch reads its input state and writes fresh tensors
    torch.cuda.synchronize()
    changed = [f for f in TENSOR_FIELDS
               if not torch.equal(getattr(s, f), before[f])]
    require(not changed, f"a launch changed its input state's {changed}")
    require(bool((a.attempts == s.attempts + 256).all())
            and a.positions.data_ptr() != s.positions.data_ptr(),
            "attempts or the output positions")
    # the launch arithmetic the CPU tests hold is the built kernel's
    table_ns = list(range(1, 1025)) + K1_PATH_EDGES
    wrong = [n for n in table_ns
             if cm.kernel_group_threads(n) != cm.group_threads(n)]
    require(not wrong and cm.kernel_group_threads(0) == 0,
            f"threads per chain differ from the kernel's table at N={wrong[:5]}")
    wrong = [n for n in table_ns
             if cm.kernel_memory_path(n)[0] != cm.memory_path(n, optin)]
    require(not wrong and cm.kernel_memory_path(0)[0] == -1,
            f"memory paths differ from the kernel's table at N={wrong[:5]} "
            f"(opt-in maximum {optin} bytes)")
    # the kernel's branch-free division against IEEE division over the
    # operands a pair term gives it: sigma^2 of order 1 over r^2 from the
    # clamp at 1e-12 up to the box's diagonal, 4M log-uniform draws each
    g = torch.Generator(device=DEVICE)
    g.manual_seed(17)
    num = torch.exp(torch.empty(1 << 22, device=DEVICE).uniform_(
        -3.0, 3.0, generator=g))
    den = torch.exp(torch.empty(1 << 22, device=DEVICE).uniform_(
        -27.7, 9.0, generator=g))
    den[:4] = torch.tensor([1e-12, 0.25, 6.25, 1.0], device=DEVICE)
    quotient = cm.kernel_division(num, den)
    torch.cuda.synchronize()
    off = int((quotient != num / den).sum())
    require(off == 0, f"the kernel's division differs from a / b at {off} "
                      f"of {num.numel()} operands")
    phase("3 kernel vs plain, pathwise", max_abs_err=f"{err:.3g}",
          division_bit_equal=num.numel(), shared_optin_bytes=optin,
          wide_paths=",".join(f"{n}:{p}" for n, p in paths.items()),
          near_tie=NEAR_TIE, pos_atol=POS_ATOL, e_rtol=E_RTOL, e_atol=E_ATOL)
    return err


def jittered_lattices(n: int, c: int, seed: int, rho: float = 0.3):
    """A (c, n, 2) float32 batch on the card: the ``initialise_fcc``
    lattice jittered by +-0.05 per chain (numpy seed), wrapped; and its box."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import initialise_fcc

    lattice, box = initialise_fcc(n, rho, 1.0)
    rng = np.random.default_rng(seed)
    pos = lattice + rng.uniform(-0.05, 0.05, size=(c, n, 2))
    pos = np.stack([pos[..., 0] % box.size_x, pos[..., 1] % box.size_y], -1)
    return torch.as_tensor(pos, dtype=torch.float32, device=DEVICE), box


def pair_magnitudes(spec, positions):
    """Per chain: the sum of |pair energy| plus |well energy|, and of
    |pair virial|, over the pairs i < j: the scale of K2's rounding."""
    import torch

    from flowstate_tpu_torch.ops import lennard_jones_energy_virial, min_image
    from flowstate_tpu_torch.ops.box import squared_norm
    from flowstate_tpu_torch.ops.pair_energy import _well_energy

    n = spec.num_particles
    d = min_image(positions[:, :, None, :] - positions[:, None, :, :],
                  spec.box)
    r = torch.sqrt(torch.clamp(squared_norm(d), min=1e-24))
    e, w = lennard_jones_energy_virial(r, spec.epsilon, spec.sigma,
                                       spec.cutoff)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                  device=positions.device), diagonal=1)
    zero = torch.zeros((), device=positions.device)
    e_mag = torch.where(upper, e.abs(), zero).sum((1, 2)) + _well_energy(
        spec, positions).abs().sum(-1)
    return e_mag, torch.where(upper, w.abs(), zero).sum((1, 2))


def compare_pair(spec, positions, label: str, overlaps=()) -> float:
    """K2 and its plain version on one batch: +inf in exactly the chains
    ``overlaps`` (in both), finite values within the stated tolerance
    elsewhere, and the same bits from a second kernel call.  Returns the
    largest |difference| over the finite energies and virials."""
    import torch

    from flowstate_tpu_torch.ops import cuda_pair as cp

    e_k, w_k = cp.total_energy_virial_kernel(spec, positions)
    e_k2, w_k2 = cp.total_energy_virial_kernel(spec, positions)
    e_p, w_p = cp.total_energy_virial_plain(spec, positions)
    torch.cuda.synchronize()
    require(torch.equal(e_k, e_k2) and torch.equal(w_k, w_k2),
            f"{label}: two kernel calls differ")
    inf_k, inf_p = torch.isinf(e_k), torch.isinf(e_p)
    got = torch.nonzero(inf_k).flatten().tolist()
    require(got == list(overlaps) and torch.equal(inf_k, inf_p)
            and torch.equal(inf_k, torch.isinf(w_k)),
            f"{label}: overlap chains: kernel {got[:8]} plain "
            f"{torch.nonzero(inf_p).flatten().tolist()[:8]}, expected "
            f"{list(overlaps)}")
    require(bool((e_k[inf_k] > 0).all() and (w_k[inf_k] > 0).all()),
            f"{label}: an overlap is not +inf")
    ok = ~inf_k
    require(bool(torch.isfinite(e_k[ok]).all()
                 and torch.isfinite(w_k[ok]).all()),
            f"{label}: non-finite energy without an overlap")
    e_mag, w_mag = pair_magnitudes(spec, positions)
    de = (e_k - e_p)[ok].abs()
    dw = (w_k - w_p)[ok].abs()
    require(bool((de <= PAIR_RTOL * e_mag[ok] + PAIR_ATOL).all()),
            f"{label}: energies differ by {float(de.max())}")
    require(bool((dw <= PAIR_RTOL * w_mag[ok] + PAIR_ATOL).all()),
            f"{label}: virials differ by {float(dw.max())}")
    err = max(float(de.max()), float(dw.max()))
    print(f"  {label}: C={positions.shape[0]} N={spec.num_particles} "
          f"overlap_chains={int(inf_k.sum())} e_err={float(de.max()):.3g} "
          f"w_err={float(dw.max()):.3g} "
          f"e_rel={float((de / e_mag[ok]).max()):.3g}", flush=True)
    return err


def wrap(pos, box):
    """Positions taken into the box [0, L_x) x [0, L_y)."""
    import torch

    size = torch.tensor([box.size_x, box.size_y], device=pos.device)
    return torch.remainder(pos, size)


# K2 against its plain version: (C, N, wells, {chain: (i, j)}) where
# particle j is put 0.1 from particle i, inside the hard core
PAIR_CHECK_SHAPES = (
    (7, 1, 2, {}), (5, 2, 2, {4: (0, 1)}),
    (9, 5, 2, {8: (4, 0)}), (37, 17, 0, {0: (3, 11), 36: (16, 0)}),
    (2048, 32, 0, {}), (64, 257, 0, {}), (64, 300, 0, {}),
    (32, 1000, 0, {}), (128, 1024, 0, {}),
    (3, 1024, 2, {1: (1023, 0), 2: (0, 512)}),
    (8, 300, 2, {2: (17, 211), 5: (17, 211)}),
    (4, 4096, 0, {}), (1, 8192, 0, {}))
# K2's launch table, held against the Python mirror: every lane-group size
# and its edges, clusters around powers of two and the 52 KB staging edge,
# at chain counts that leave warps and waves part-filled
PAIR_TABLE_NS = list(range(1, 41)) + [63, 64, 65, 127, 128, 129, 255, 256,
                                      257, 300, 511, 512, 513, 1000, 1023,
                                      1024, 1025, 4095, 4096, 4097, 4437,
                                      4438, 8192, 92416]
PAIR_TABLE_CS = (1, 2, 3, 7, 9, 37, 64, 100, 128, 512, 2048, 6144, 100000)


def phase_pair_kernel() -> float:
    """K2 against its plain version at the shapes the paths give it and at
    each path's edges (lane groups at N=1, 2, 5, 17 with shadow groups past
    the last chain; clusters of 1 to 8 blocks at N=257 ... 4096, staged; N=8192
    read from device memory), overlap batches across lanes, cluster ranks
    and the circulant wrap, and bit-identical repeats; then the Python
    mirror of the launch table against the built kernel's own."""
    import torch

    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.ops import Box, SystemSpec
    from flowstate_tpu_torch.ops import cuda_pair as cp

    wells = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    errs = []
    pos, _ = init_alternating_wells(100, 3, 0.03)
    errs.append(compare_pair(reference_spec(3),
                             torch.as_tensor(pos, dtype=torch.float32,
                                             device=DEVICE),
                             "main path (100, 3), wells"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c, n, w, overlaps in PAIR_CHECK_SHAPES:
        pos, box = jittered_lattices(n, c, seed=n + c)
        for chain, (i, j) in overlaps.items():
            pos[chain, j] = pos[chain, i] + 0.1
        pos = wrap(pos, box)
        spec = SystemSpec.create(n, box, **(wells if w else {}))
        sh = cp.launch_shape(n, c, sms)
        errs.append(compare_pair(
            spec, pos, f"({c}, {n}) wells={w} threads={sh.threads} "
            f"cluster={sh.cluster} staged={sh.shared_bytes > 0}",
            overlaps=sorted(overlaps)))
    # every pair of neighbours 1e-5 inside the cutoff: a square lattice of
    # spacing 2.49999 across the box's edges, shifted per chain; a pair the
    # kernel dropped would move the virial by 0.062
    side, a = 8, 2.49999
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    grid = torch.stack(torch.meshgrid(torch.arange(side), torch.arange(side),
                                      indexing="ij"), -1).reshape(-1, 2) * a
    pos = grid.to(DEVICE) + torch.rand((16, 1, 2), generator=g,
                                       device=DEVICE) * side * a
    box = Box(side * a, side * a)
    errs.append(compare_pair(SystemSpec.create(side * side, box),
                             wrap(pos.float(), box),
                             "(16, 64) neighbours at 0.999996 r_c"))
    err = max(errs)
    wrong = [(n, c, m) for m in sorted({sms, 132, 16}) for n in PAIR_TABLE_NS
             for c in PAIR_TABLE_CS
             if cp.kernel_launch_shape(n, c, m) != cp.launch_shape(n, c, m)]
    require(not wrong, f"K2's launch differs from the mirror at (N, C, SMs) "
                       f"{wrong[:5]}")
    try:
        cp.kernel_launch_shape(0, 1, sms)
    except ValueError:
        pass
    else:
        raise AssertionError("K2's launch table took N=0")
    phase("3b pair kernel vs plain", max_abs_err=f"{err:.3g}",
          rtol_of_magnitudes=PAIR_RTOL, atol=PAIR_ATOL,
          launch_table_checked=len(PAIR_TABLE_NS) * len(PAIR_TABLE_CS)
          * len({sms, 132, 16}))
    return err


def phase_statistics(num_chains: int = 16384, eq_steps: int = 5000,
                     moves: int = 8192) -> None:
    import numpy as np
    import torch

    from flowstate_tpu_torch.analysis.wells import classify_particles
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
    from flowstate_tpu_torch.mcmc.state import init_chain_state, resync_energy

    spec = reference_spec(3)
    pos, _ = init_alternating_wells(num_chains, 3, 0.03)
    s0 = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 2024, 0.65)
    res = {}
    for name, mover in (("kernel", cm.run_moves_kernel),
                        ("plain", cm.run_moves_plain)):
        def move_fn(s, n, mover=mover):
            return mover(spec, 1.0, s, n)

        s = run_equilibration(spec, 1.0, s0, eq_steps, 5000, 0.5, move_fn)
        att0, acc0 = int(s.attempts.sum()), int(s.accepts.sum())
        s = move_fn(s, moves)
        exact = resync_energy(spec, s)
        e_pp = (exact.energy / 3).double()
        labels = classify_particles(s.positions.cpu().numpy(), 5.0, 1.2)
        res[name] = {
            "acceptance": (int(s.accepts.sum()) - acc0)
                          / (int(s.attempts.sum()) - att0),
            "drift": float((s.energy - exact.energy).abs().max()),
            "drift_mean": float((s.energy - exact.energy).abs().mean()),
            "e_mean": float(e_pp.mean()), "e_var": float(e_pp.var()),
            "occ": (float(np.mean(labels == 0)), float(np.mean(labels == 1))),
        }
    k, p = res["kernel"], res["plain"]
    sigma = np.sqrt((k["e_var"] + p["e_var"]) / num_chains)
    dist = abs(k["e_mean"] - p["e_mean"]) / sigma
    require(abs(k["acceptance"] - p["acceptance"]) < 0.02,
            f"acceptance kernel {k['acceptance']} vs plain {p['acceptance']}")
    require(k["drift"] < 1e-2, f"kernel energy drift {k['drift']}")
    require(dist < 4.0, f"energy/particle {k['e_mean']} vs {p['e_mean']}: "
                        f"{dist:.2f} sigma")
    phase("4 statistics", chains=num_chains, moves=moves,
          acceptance=f"{k['acceptance']:.4f}/{p['acceptance']:.4f}",
          drift_max_mean=f"{k['drift']:.3g}/{k['drift_mean']:.3g}",
          e_per_particle=f"{k['e_mean']:.5f}/{p['e_mean']:.5f}",
          sigma_dist=f"{dist:.2f}",
          occupancy_AB_kernel=f"({k['occ'][0]:.4f},{k['occ'][1]:.4f})",
          occupancy_AB_plain=f"({p['occ'][0]:.4f},{p['occ'][1]:.4f})")


def phase_exact_physics() -> None:
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.state import init_chain_state

    spec, exact = exact_n1_delta_f()
    lx, ly = spec.box.size_x, spec.box.size_y
    radius = 1.1 * spec.r0

    c = 256
    pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (c, 1, 1))
    pos0[c // 2:, :, 0] = 3 * lx / 4
    s = init_chain_state(spec, torch.as_tensor(pos0, device=DEVICE), 7, 1.5)
    s = cm.run_moves_kernel(spec, 1.0, s, 300)
    s, obs = cm.run_production_kernel(spec, 1.0, s, 600, 5)
    xy = obs.positions.reshape(-1, 2).cpu().numpy()
    sa = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    sb = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    sampled = float(np.log(sb.sum() / sa.sum()))
    require(abs(sampled - exact) < 0.12,
            f"N=1 delta F sampled {sampled} vs exact {exact}")
    phase("5 exact physics", delta_f_sampled=f"{sampled:.4f}",
          delta_f_exact=f"{exact:.4f}", bound=0.12)


def phase_main_path(total_steps: int = 10_000_000) -> dict:
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import mcmc_only
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.utils.config import mcmc_only_config

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        config = mcmc_only_config(experiment_id="chip_smoke", output_dir=out)
        samples = total_steps // config.num_chains // config.sampling_frequency
        eq_blocks, eq_rest = divmod(config.equilibration_steps,
                                    config.adjusting_frequency)
        expected = eq_blocks + (1 if eq_rest else 0) + samples
        # K2: the initial energies, then one resync per production block,
        # one launch each
        expected_k2 = 1 + samples
        cm.LAUNCHES = 0
        cp.LAUNCHES = 0
        result = mcmc_only.run(config, total_steps, device=DEVICE)
        torch.cuda.synchronize()
        launches, launches_k2 = cm.LAUNCHES, cp.LAUNCHES
        require(launches == expected,
                f"main path launched the move kernel {launches} times, "
                f"schedule implies {expected}")
        require(launches_k2 == expected_k2,
                f"main path launched the pair kernel {launches_k2} times, "
                f"schedule implies {expected_k2}")
        d = result["directory"]
        needed = ["params.json", "experiment.log", "metrics.jsonl",
                  os.path.join(out, "evidence", "chip_smoke_data.json")]
        for i in range(config.num_chains):
            needed += [os.path.join("mc_runs", f"run_{i + 1:03d}", f)
                       for f in ("sampled_data.csv", "mc_run_configs.npy")]
        # the figures' data, written with or without matplotlib: per run
        # for the first ten runs, then across runs
        for i in range(min(10, config.num_chains)):
            needed += [os.path.join("mc_runs", f"run_{i + 1:03d}", f)
                       for f in ("well_statistics_data.json",
                                 f"avg_x_coordinate_run_{i + 1}_data.json")]
        needed += ["avg_free_energy_data.json", "state_histogram_data.json",
                   "multi_avg_x_data.json"]
        missing = [f for f in needed if not os.path.exists(os.path.join(d, f))]
        require(not missing, f"missing artifacts {missing[:5]}")
        rows = np.genfromtxt(os.path.join(d, "mc_runs", "run_001",
                                          "sampled_data.csv"),
                             delimiter=",", skip_header=1, usecols=(1, 3))
        require(rows.shape == (samples, 2) and np.isfinite(rows).all(),
                "sampled_data.csv energies/pressures not finite")
        with open(os.path.join(d, "avg_free_energy_data.json")) as f:
            free = json.load(f)
        with open(os.path.join(d, "state_histogram_data.json")) as f:
            states = json.load(f)["state_counts"]
        require(free["final_mean"] == result["delta_f_mean"]
                and len(free["mean"]) == samples
                and sum(states.values()) == config.num_chains * samples,
                f"avg_free_energy / state_histogram data: {free['final_mean']}"
                f", {len(free['mean'])} samples, {sum(states.values())} "
                "configurations")
        drawn = os.path.exists(os.path.join(d, "avg_free_energy.png"))
    acc = result["production_acceptance"]
    e_pp = result["energy_per_particle"]
    require(0.3 < acc < 0.7, f"production acceptance {acc}")
    require(abs(e_pp + 10.7) < 0.2, f"energy per particle {e_pp}")
    phase("6 main path", launches=launches, expected=expected,
          launches_k2=launches_k2, expected_k2=expected_k2,
          acceptance=f"{acc:.4f}", e_per_particle=f"{e_pp:.4f}",
          delta_f=f"{result['delta_f_mean']:.4f}+-{result['delta_f_sem']:.4f}",
          data_json_files=sum(f.endswith("_data.json") for f in needed),
          figures_drawn=drawn, wall_s=f"{result['wall_s']:.2f}")
    return {"launches": launches, "launches_k2": launches_k2}


def phase_timing(card: str, c: int = 16384, moves: int = 1000) -> dict:
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.tools.n_scaling import k1_bound

    spec = reference_spec(3)

    def state(c):
        pos, _ = init_alternating_wells(c, 3, 0.03)
        return init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 5,
                                0.65)

    # the main path's launch: 100 chains x 150 moves
    s100 = state(100)
    ms = cuda_ms(lambda: cm.run_moves_kernel(spec, 1.0, s100, 150), 200)
    plain_ms = cuda_ms(lambda: cm.run_moves_plain(spec, 1.0, s100, 150), 3)
    # a call of the wrapper is one device kernel, K1, and nothing else (no
    # layout copy, clone, fill or add).  The profiler drops records, so
    # the count may fall short of the calls, never exceed them; skipped if
    # the profiler sees no kernel
    calls = 20
    events = one_kernel_per_call(
        lambda: cm.run_moves_kernel(spec, 1.0, s100, 150), calls,
        "metropolis_moves_kernel", "run_moves_kernel")
    device_launch_ms = (sum(e.time_range.elapsed_us() for e in events)
                        / max(len(events), 1) / 1e3)

    # throughput: c chains x moves, 30 launches vs 2 for plain
    s = state(c)
    cm.run_moves_kernel(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        s = cm.run_moves_kernel(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    k_rate = 30 * c * moves / (time.perf_counter() - t0)
    s = state(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        s = cm.run_moves_plain(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    p_rate = 2 * c * moves / (time.perf_counter() - t0)
    require(np.isfinite(k_rate) and np.isfinite(p_rate), "timing failed")
    bound, bound_by = k1_bound(100, 3, 2, 150)
    big_bound, big_by = k1_bound(c, 3, 2, moves)
    phase("7 timing", card=f"'{card}'",
          main_path_launch_ms=f"{ms:.4f}",
          main_path_device_ms=f"{device_launch_ms:.4f}",
          device_kernels_per_call=len(events) / calls,
          main_path_plain_ms=f"{plain_ms:.2f}",
          main_path_bound_ms=f"{bound:.3g}", bound_by=bound_by,
          kernel_moves_per_s=f"{k_rate:.6g}", plain_moves_per_s=f"{p_rate:.6g}",
          chains=c, moves_per_launch=moves,
          launch_ms=f"{c * moves / k_rate * 1e3:.4f}",
          launch_bound_ms=f"{big_bound:.3g}", launch_bound_by=big_by)
    k1 = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": bound_by}
    return {"k1": k1, "k2": time_pair_kernel(card),
            "block": time_production_block()}


def device_kernels(fn, reps: int) -> list:
    """The profiler's device events (kernels, copies, memsets) of ``reps``
    calls of ``fn`` after one warm-up call (empty if the profiler records
    none)."""
    from flowstate_tpu_torch.tools.pair_kernel_times import device_events

    return device_events(fn, reps)


def one_kernel_per_call(fn, calls: int, name_part: str, label: str,
                        at_least_one: bool = False) -> list:
    """The profiler's device events of ``calls`` calls of ``fn``, held to
    one kernel a call: only the kernel named ``name_part``, at most one a
    call.  The profiler loses records (F6: 16 and 17 of 20 in phase 7's
    windows, none of 20 in one of phase 3's), so the count may fall short
    of the calls, and a window with none is profiled once more; empty if
    the profiler still records nothing, which ``at_least_one`` refuses."""
    for _ in range(2):
        events = device_kernels(fn, calls)
        if events:
            break
    names = sorted({e.name for e in events})
    require((not events and not at_least_one)
            or (events and len(events) <= calls and len(names) == 1
                and name_part in names[0]),
            f"{calls} calls of {label} ran {len(events)} device kernels: "
            f"{names[:6]}")
    return events


def device_ms(fn, reps: int) -> float:
    """Milliseconds of device time per call of ``fn``: the durations of
    the kernels it launches, summed over ``reps`` profiled calls after one
    warm-up call (0 if the profiler records no device kernel)."""
    return sum(e.time_range.elapsed_us()
               for e in device_kernels(fn, reps)) / 1e3 / reps


def time_pair_kernel(card: str) -> dict:
    """K2 and its plain version at the main path's shape (100 chains, N=3,
    wells) and at the single-run CLI's (128, 1024): the time of a call by
    CUDA events over back-to-back calls, and by the profiler the device
    time of its kernels and their count, one per call; the bound counted
    on these inputs (the LJ work of the pairs inside the cutoff) beside the
    bound that charges every pair with it."""
    import torch

    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.ops import SystemSpec
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.tools.n_scaling import (
        k2_bound, pairs_inside_cutoff,
    )

    pos3, _ = init_alternating_wells(100, 3, 0.03)
    pos3 = torch.as_tensor(pos3, dtype=torch.float32, device=DEVICE)
    spec3 = reference_spec(3)
    pos1k, box = jittered_lattices(1024, 128, seed=2)
    spec1k = SystemSpec.create(1024, box, num_wells=0)
    out = {}
    calls = 20
    for label, spec, pos, reps, plain_reps in (
            ("main_path", spec3, pos3, 1000, 100),
            ("n1024", spec1k, pos1k, 100, 5)):
        def call(spec=spec, pos=pos):
            return cp.total_energy_virial_kernel(spec, pos)

        k_ms = cuda_ms(call, reps)
        p_ms = cuda_ms(lambda: cp.total_energy_virial_plain(spec, pos),
                       plain_reps)
        c, n = pos.shape[0], spec.num_particles
        inside = pairs_inside_cutoff(spec, pos)
        b_ms, b_by = k2_bound(c, n, spec.num_wells, inside)
        all_ms, all_by = k2_bound(c, n, spec.num_wells)
        # one device kernel per call (the profiler drops records, never
        # adds one); skipped if it sees none
        events = one_kernel_per_call(call, calls, "pair_",
                                     f"K2 at ({c}, {n})")
        out[label] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "all_pairs_bound_ms": all_ms, "all_pairs_bound_by": all_by,
            "pairs": c * (n * (n - 1) // 2), "pairs_inside": inside,
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in events) / 1e3 / calls,
            "device_kernels_per_call": len(events) / calls,
            "plain_device_ms": device_ms(
                lambda: cp.total_energy_virial_plain(spec, pos), 3)}
    phase("7b pair kernel timing", card=f"'{card}'",
          **{f"{k}_{f}": (f"{v[f]:.4g}" if isinstance(v[f], float) else v[f])
             for k, v in out.items() for f in v})
    return out


def time_production_block(blocks: int = 100) -> dict:
    """The main path's production block by ``pair_kernel_times``: host ms
    per block, then the card's busy share of a profiled window; K1 once
    per block."""
    from flowstate_tpu_torch.tools.pair_kernel_times import production_block

    b = production_block(blocks)
    top = sorted(b["us_per_block_by_kernel"].items(), key=lambda kv: -kv[1])
    for name, us in top[:6]:
        print(f"  device {us:9.2f} us/block  {name[:70]}", flush=True)
    # K1 once per block, by the wrapper's count; the profiler loses some
    # records (89 of 100 in one run), so its count may fall short of the
    # launches, never exceed them
    require(b["move_launches"] == blocks
            and b["move_kernels"] <= b["move_launches"],
            f"{b['move_launches']} move-kernel launches, "
            f"{b['move_kernels']} recorded by the profiler, in {blocks} "
            "blocks")
    measured = b["idle_share"] is not None
    phase("7c production block", block_ms=f"{b['block_ms']:.4f}",
          profiled_wall_ms_per_block=f"{b['profiled_wall_ms_per_block']:.4f}",
          device_busy_ms_per_block=f"{b['device_busy_ms_per_block']:.4f}",
          idle_share=(f"{b['idle_share']:.3f}" if measured
                      else "not_measured"),
          device_kernels_per_block=f"{b['device_kernels_per_block']:.1f}",
          move_launches=b["move_launches"],
          move_kernels_recorded=b["move_kernels"])
    return {"block_ms": b["block_ms"], "idle_share": b["idle_share"]}


# phase 8's particle counts and samples a chain: the CLI's N=1024, then
# K1's 48 KB path (2048) and its opted-in path (8192), whose production
# configurations (C x samples x N x 2 float32) stay at 84 MB
SINGLE_RUN_NS = ((1024, 40), (2048, 40), (8192, 10))


def phase_single_run(card: str, num_chains: int = 128, n: int = 1024,
                     samples: int = 40) -> dict:
    """The NVT single-run CLI at ``n`` particles, rho=0.3, T=1, no wells,
    fcc start, through both kernels: launch counts against the schedule,
    finite observables, a steady negative E/N over the second half,
    acceptance, and the NPZ and CSV shapes.  The schedule is N=1024's
    (2000 equilibration moves adjusting every 500, 8000 production moves)
    scaled by n / 1024, so that each particle is tried as often at every
    N; ``samples`` a chain."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import single_run
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp

    scale = max(1, n // 1024)
    eq, adjust, prod = 2000 * scale, 500 * scale, 8000 * scale
    every = prod // samples
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        argv = ["--temperature", "1.0", "--num_particles", str(n),
                "--initial_rho", "0.3", "--num_wells", "0",
                "--initialisation_type", "all",
                "--num_chains", str(num_chains),
                "--equilibration_steps", str(eq),
                "--adjusting_frequency", str(adjust),
                "--production_steps", str(prod),
                "--sampling_frequency", str(every),
                "--initial_max_displacement", "1.0",
                "--output_path", out, "--experiment_id", "single_run",
                "--seed", "0", "--device", DEVICE]
        cm.LAUNCHES = 0
        cp.LAUNCHES = 0
        t0 = time.perf_counter()
        summary = single_run.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1, k2 = cm.LAUNCHES, cp.LAUNCHES
        expected_k1 = eq // adjust + (1 if eq % adjust else 0) + samples
        expected_k2 = 1 + samples
        require(k1 == expected_k1 and k2 == expected_k2,
                f"single run launched K1 {k1} (expected {expected_k1}) and "
                f"K2 {k2} (expected {expected_k2}) times")
        d = os.path.join(out, "single_run")
        configs = np.load(os.path.join(d, "production_configs.npz"))["configs"]
        require(configs.shape == (num_chains, samples, n, 2),
                f"NPZ configs {configs.shape}")
        half = np.sqrt(n / 0.3) / 2
        require(bool(np.all(np.abs(configs) <= half + 1e-4)),
                "NPZ configs outside the centred box")
        rows = np.genfromtxt(os.path.join(d, "sampled_data.csv"),
                             delimiter=",", skip_header=1,
                             usecols=(0, 1, 2, 3))
        require(rows.shape == (samples, 4) and np.isfinite(rows).all(),
                f"CSV rows {rows.shape} or not finite")
        require(np.array_equal(rows[:, 0],
                               eq + every * np.arange(1, samples + 1)),
                "CSV cycle numbers")
    second = rows[samples // 2:, 1]               # chain 0's E/N
    q1 = second[: len(second) // 2].mean()
    q2 = second[len(second) // 2:].mean()
    acc = summary["acceptance_fraction"]
    require(np.isfinite(summary["mean_energy_per_particle"])
            and np.isfinite(summary["mean_pressure"]), "summary not finite")
    require(bool((second < 0).all()), f"E/N not negative: {second}")
    # steady: the two quarters of the second half within 10% of |E/N|
    require(abs(q2 - q1) < 0.1 * abs(q1),
            f"E/N drifts over the second half: {q1:.4f} -> {q2:.4f}")
    require(0.2 < acc < 0.8, f"acceptance {acc}")

    # K1 at this shape: one launch of `every` moves, against its bound
    from flowstate_tpu_torch.mcmc import initialise_fcc
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.ops import SystemSpec
    from flowstate_tpu_torch.tools.n_scaling import k1_bound

    lattice, box = initialise_fcc(n, 0.3, 1.0)
    spec = SystemSpec.create(n, box, num_wells=0)
    s = init_chain_state(spec, torch.as_tensor(
        np.broadcast_to(lattice, (num_chains, n, 2)).copy(), device=DEVICE),
        0, float(summary["final_max_displacement"]))
    k1_ms = cuda_ms(lambda: cm.run_moves_kernel(spec, 1.0, s, every), 20)
    k1_bound_ms, k1_by = k1_bound(num_chains, n, 0, every)
    phase(f"8 single run N={n}", card=f"'{card}'", n=n, chains=num_chains,
          k1_path=cm.PATH_NAMES[cm.memory_path(n)],
          launches_k1=k1, expected_k1=expected_k1, launches_k2=k2,
          expected_k2=expected_k2, acceptance=f"{acc:.4f}",
          e_per_particle=f"{summary['mean_energy_per_particle']:.5f}",
          e_chain0_quarters=f"{q1:.5f}/{q2:.5f}",
          pressure=f"{summary['mean_pressure']:.5f}",
          max_disp=f"{summary['final_max_displacement']:.4f}",
          wall_s=f"{wall_s:.2f}", k1_launch_ms=f"{k1_ms:.3f}",
          k1_launch_bound_ms=f"{k1_bound_ms:.4g}", k1_bound_by=k1_by,
          moves_per_launch=every)
    return {"wall_s": wall_s, "k1_ms": k1_ms, "k1_bound_ms": k1_bound_ms}


def sass_mix(library: str) -> dict:
    """Per n_acc instance of the issue-rate kernel in ``library``,
    by ``cuobjdump -sass``: the opcode counts of the whole function and of
    its largest loop (the instructions from a backward branch's target to
    the branch)."""
    from flowstate_tpu_torch.kernels.sass import loop_mix

    return loop_mix(library, "issue_rate_kernel")


def phase_issue_rate(card: str) -> dict:
    """K3: its SASS (the unrolled FFMA chains, no local memory, no fp64),
    the kernel at every compiled width against its plain version with
    FFMA rounding at the probe's 4 x SMs tiles, at n_acc 16 and 4 tiles
    against the plain version that rounds twice, their times, and the
    fp32 roof read at the JAX tool's defaults (iters 65536, depth 8,
    n_acc 16 ... 128)."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.kernels import build
    from flowstate_tpu_torch.tools import n_scaling as ns

    mix = sass_mix(build.build().paths["issue_rate"])
    require(set(mix) == set(ns.ISSUE_RATE_WIDTHS),
            f"issue_rate instances in the SASS: {sorted(mix)}")
    depth = ns.ISSUE_RATE_DEPTH
    for n_acc, m in sorted(mix.items()):
        ops, loop = m["all"], m["loop"]
        bad = {op: k for op, k in ops.items()
               if op in ("LDL", "STL", "DADD", "DMUL", "DFMA", "F2F")}
        ffma, size = loop.get("FFMA", 0), sum(loop.values())
        require(ffma >= n_acc * depth and not bad,
                f"issue_rate<{n_acc}>: {ffma} FFMA in the loop, "
                f"local memory or fp64 {bad}")
        # the loop is the chains' FFMA and the loop's own few instructions
        require(ffma >= 0.9 * size, f"issue_rate<{n_acc}>: loop {loop}")
        print(f"  SASS issue_rate<{n_acc}> (depth {depth}): loop {size} "
              f"instructions, FFMA {ffma} ({ffma / size:.3f}) "
              + " ".join(f"{op}={k}" for op, k in sorted(loop.items())
                         if op != "FFMA")
              + f"; function {sum(ops.values())} instructions", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((4, 8, 128), dtype=np.float32),
                        device=DEVICE)
    y_k = ns.issue_rate_kernel(x, 16, **K3_CHECK)
    y_p = ns.issue_rate_plain(x, 16, **K3_CHECK)
    unfused = float(((y_k - y_p).abs() / y_p.abs()).max())
    require(unfused <= K3_UNFUSED_RTOL,
            f"K3 at 4 tiles differs from the plain version rounding twice "
            f"by {unfused} relative")
    print(f"  K3 vs plain (two roundings) at (4, 8, 128), n_acc 16, "
          f"{K3_CHECK}: max_rel={unfused:.4g}", flush=True)

    x = torch.as_tensor(rng.random((4 * sms, 8, 128), dtype=np.float32),
                        device=DEVICE)
    err = rel = 0.0
    for n_acc in ns.ISSUE_RATE_WIDTHS:
        y_k = ns.issue_rate_kernel(x, n_acc, **K3_CHECK)
        y_p = ns.issue_rate_plain(x, n_acc, **K3_CHECK, fused=True)
        # the loop's effect: the output less the sum of the initial x + i
        effect = (y_p - ns.issue_rate_plain(x, n_acc, depth, 0)).abs()
        require(bool(torch.isfinite(y_k).all()), "K3 output not finite")
        d = (y_k - y_p).abs()
        r = float((d / y_p.abs()).max())
        require(r <= K3_RTOL, f"K3 n_acc {n_acc} differs by {r} relative")
        print(f"  K3 vs plain (FFMA rounding) at ({4 * sms}, 8, 128), n_acc "
              f"{n_acc}, {K3_CHECK}: max_abs={float(d.max()):.4g} "
              f"max_rel={r:.4g} of_loop_effect="
              f"{float(d.max() / effect.min()):.4g} "
              f"bit_equal={float((d == 0).float().mean()):.6f}", flush=True)
        err, rel = max(err, float(d.max())), max(rel, r)
    ms = cuda_ms(lambda: ns.issue_rate_kernel(x, 16, **K3_CHECK), 20)
    plain_ms = cuda_ms(lambda: ns.issue_rate_plain(x, 16, **K3_CHECK), 2)
    bound, bound_by = ns.k3_bound(x.numel(), 16, **K3_CHECK)

    rates = ns.calibrate_fp32_ops()
    best = max(rates.values())
    require(all(np.isfinite(v) and v > 0 for v in rates.values()),
            f"fp32 rates {rates}")
    # a probe under a quarter of the peak measures latency or spills
    require(best > 0.25 * ns.PEAK_FP32_FLOPS, f"fp32 roof {best:.4g} ops/s")
    phase("9 issue-rate probe", card=f"'{card}'", max_abs_err=f"{err:.4g}",
          max_rel_err=f"{rel:.4g}", rtol=K3_RTOL,
          unfused_rel_err=f"{unfused:.4g}", tiles=4 * sms,
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
          bound_ms=f"{bound:.4f}", bound_by=bound_by,
          **{f"ops_per_s_n{a}": f"{v:.6g}" for a, v in rates.items()},
          best_of_peak=f"{best / ns.PEAK_FP32_FLOPS:.4f}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "fp32_ops_per_s": best}


def phase_n_scaling(card: str, ns_list=(8, 128, 1024), moves: int = 256,
                    repeats: int = 1) -> dict:
    """The N-scaling tool, cut to three N and 256 moves: K1, K2 and K3
    launch counts against its schedule, every rate and fraction of the
    roof finite and positive, the rows' keys; then fast-math K1 against
    the plain engine pathwise at N=1024, 512 chains (the 256-thread
    groups the tool times)."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import initialise_fcc
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.ops import SystemSpec
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.tools import n_scaling as ns

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        path = os.path.join(out, "n_scaling.json")
        cm.LAUNCHES = cp.LAUNCHES = ns.LAUNCHES = 0
        t0 = time.perf_counter()
        ns.main(["--ns", *map(str, ns_list), "--moves", str(moves),
                 "--repeats", str(repeats), "--out", path])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1, k2, k3 = cm.LAUNCHES, cp.LAUNCHES, ns.LAUNCHES
        with open(path) as f:
            saved = json.load(f)
    # per N: the equilibration launch, then two warm and `repeats` timed
    # calls, exact and fast-math; K2: the initial energies, the resync
    # after equilibration and one per timed call, one launch each; K3: four
    # widths, one warm-up and two timed calls each
    calls = 2 * (2 + repeats)
    expected = (len(ns_list) * (1 + calls), len(ns_list) * (2 + calls),
                4 * 3)
    require((k1, k2, k3) == expected,
            f"n_scaling launched K1, K2, K3 {(k1, k2, k3)} times, schedule "
            f"implies {expected}")
    keys = {"n", "chains", "c_blk", "threads_per_chain", "moves_per_call",
            "plain_moves_per_call",
            "plain_moves_per_s", "kernel_moves_per_s",
            "kernel_fast_moves_per_s", "speedup", "ops_per_move",
            "row_elems_per_s", "frac_of_roof"}
    rows = saved["rows"]
    require([r["n"] for r in rows] == list(ns_list)
            and [r["chains"] for r in rows]
            == [ns.chains_for(n) for n in ns_list]
            and [r["threads_per_chain"] for r in rows]
            == [cm.kernel_group_threads(n) for n in ns_list], "n_scaling rows")
    for r in rows:
        require(set(r) == keys, f"row keys {sorted(set(r) ^ keys)}")
        vals = [r[k] for k in keys - {"n", "chains", "c_blk",
                                      "threads_per_chain"}]
        require(all(np.isfinite(v) and v > 0 for v in vals),
                f"N={r['n']}: a rate is not finite and positive: {r}")
    require(saved["device"]["name"] == torch.cuda.get_device_name(0),
            f"n_scaling device {saved['device']}")

    lattice, box = initialise_fcc(1024, 0.3, 1.0)
    spec = SystemSpec.create(1024, box, num_wells=0)
    chains = ns.chains_for(1024)
    s = init_chain_state(spec, torch.as_tensor(
        np.broadcast_to(lattice, (chains, 1024, 2)).copy(), device=DEVICE),
        6, 1.0)
    err = compare_pathwise(spec, s, 64, 16, "N=1024 fast_math",
                           fast_math=True)
    phase("10 n-scaling", card=f"'{card}'", ns=",".join(map(str, ns_list)),
          launches_k1=k1, launches_k2=k2, launches_k3=k3,
          wall_s=f"{wall_s:.2f}", fast_math_n1024_err=f"{err:.3g}",
          **{f"moves_per_s_n{r['n']}": f"{r['kernel_moves_per_s']:.4g}"
             for r in rows},
          **{f"frac_of_roof_n{r['n']}": f"{r['frac_of_roof']:.4g}"
             for r in rows})
    return {"launches_k3": k3, "rows": rows}


def phase_sweep(num_chains: int = 64) -> dict:
    """The sweep over two densities of the default N=3 system with two
    wells: launch counts, the locked results.csv (header, two rows,
    density at its grid point, aspect ratio 1, finite pressure), the job
    directories and parameters.json."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments.sweep import (
        SweepParams, run_experiments,
    )
    from flowstate_tpu_torch.io import aggregate
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp

    densities = (0.03, 0.04)
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        params = SweepParams(density_start=densities[0],
                             density_end=densities[1], density_intervals=2,
                             equilibration_steps=1000, production_steps=15000,
                             num_chains=num_chains, output_path=out)
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        results_csv = run_experiments(params, device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1, k2 = cm.LAUNCHES, cp.LAUNCHES
        with open(results_csv) as f:
            lines = f.read().strip().split("\n")
        d = os.path.dirname(results_csv)
        jobs = sorted(j for j in os.listdir(d)
                      if os.path.isdir(os.path.join(d, j)))
        figures = sorted(f for j in jobs for f in os.listdir(os.path.join(d, j))
                         if f.endswith(".png"))
        require(os.path.isfile(os.path.join(d, "parameters.json")),
                "parameters.json missing")
    eq_blocks, eq_rest = divmod(params.equilibration_steps,
                                params.adjusting_frequency)
    samples = params.production_steps // params.sampling_frequency
    per_point = eq_blocks + (1 if eq_rest else 0) + samples
    expected = (2 * per_point, 2 * (1 + samples))
    require((k1, k2) == expected,
            f"sweep launched K1, K2 {(k1, k2)} times, schedule implies "
            f"{expected}")
    require(jobs == [f"rho_{r:.4f}_T_1.000_AR_1.00" for r in densities],
            f"job directories {jobs}")
    require(lines[0] == aggregate.RESULTS_HEADER and len(lines) == 3,
            f"results.csv {lines}")
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    require(bool(np.all(rows[:, 0] == 1.0)), f"temperatures {rows[:, 0]}")
    require(bool(np.all(np.abs(rows[:, 1] / densities - 1) <= 1e-6)),
            f"densities {rows[:, 1]} against the grid {densities}")
    require(bool(np.all(rows[:, 3] == 1.0)), f"aspect ratios {rows[:, 3]}")
    require(bool(np.all(np.isfinite(rows[:, 2]))), f"pressures {rows[:, 2]}")
    phase("11 sweep", points=len(rows), chains=num_chains, launches_k1=k1,
          expected_k1=expected[0], launches_k2=k2, expected_k2=expected[1],
          densities=",".join(f"{v:.6g}" for v in rows[:, 1]),
          pressures=",".join(f"{v:.5g}" for v in rows[:, 2]),
          figures=len(figures), wall_s=f"{wall_s:.2f}")
    return {"wall_s": wall_s}


# A1's flow at full width (utils/config.py::algorithm1_config)
A1_FLOW = dict(K=15, hidden_units=256, num_bins=32)
# the card's float32 log q against the CPU's float64 on the same weights:
# |d| <= FLOW_RTOL * (1 + |log q|).  Fifteen layers of spline log-dets
# accumulate float32 rounding; on these weights (log q from -30 to -7) the
# CPU's float32 is 3.5e-5 of (1 + |log q|) off its float64, the card's
# 6.2e-5 (an NVIDIA H100).
FLOW_RTOL = 1e-4


def seeded_flow_tree(flow, seed: int):
    """A numpy tree in the JAX layout of ``flow``'s parameters, far from
    the identity init: linear weights N(0, 0.5 / sqrt(fan_in)), biases
    N(0, 0.1), the unconditional splines' parameters N(0, 0.3)."""
    import numpy as np

    from flowstate_tpu_torch.flows import params_to_jax, tree_map

    rng = np.random.default_rng(seed)

    def leaf(a):
        if a.ndim == 3 and a.shape[-2] in (6, A1_FLOW["hidden_units"]):
            return rng.normal(0.0, 0.5 / np.sqrt(a.shape[-2]), a.shape)
        return rng.normal(0.0, 0.1 if a.ndim == 2 else 0.3, a.shape)

    return tree_map(leaf, params_to_jax(flow))


def median_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``reps`` calls of ``fn``, each between two
    CUDA events, after one warm-up call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def per_call(fn, reps: int = 2) -> dict:
    """By the profiler: device kernels and device ms per call of ``fn``
    (None where the profiler records no device kernel)."""
    events = device_kernels(fn, reps)
    if not events:
        return {"kernels": None, "device_ms": None}
    return {"kernels": len(events) / reps,
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in events) / 1e3 / reps}


def phase_flow(card: str, chains: int = 16384, batch: int = 512,
               check_points: int = 2048) -> dict:
    """A1's flow on the card at K=15, hidden 256, 32 bins, N=3: log q at
    identity init, the round trip, log q against the CPU's float64 on
    seeded weights, then the times of the flow's calls at 16,384 chains
    and of a training step at batch 512, with device kernels per call and
    the step's peak memory."""
    import math

    import numpy as np
    import torch

    from flowstate_tpu_torch.flows import build_circular_flow, params_from_jax
    from flowstate_tpu_torch.mcmc import (
        init_alternating_wells, init_chain_state, nf_big_moves,
    )
    from flowstate_tpu_torch.training import (
        TrainConfig, make_optimizer, make_train_step,
    )

    spec = reference_spec(3)
    hb = spec.box.size_x / 2.0

    def gen(seed, device=DEVICE):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return g

    flow = build_circular_flow(3, 2, hb, generator=gen(1), device=DEVICE,
                               **A1_FLOW)
    x = (torch.rand((chains, 6), generator=gen(2), device=DEVICE)
         * (2 * hb) - hb)
    with torch.no_grad():
        lp_id = flow.log_prob(x)
    want = -6 * math.log(2 * hb)
    id_err = float((lp_id - want).abs().max())
    require(id_err <= 1e-4, f"identity-init log q off {want} by {id_err}")

    tree = seeded_flow_tree(flow, 3)
    params_from_jax(tree, flow)
    with torch.no_grad():
        back = flow.inverse(flow.forward(x))
        lp = flow.log_prob(x[:check_points])
    trip_err = float((back - x).abs().max())
    require(math.isfinite(trip_err) and trip_err <= 0.01 * hb,
            f"round trip error {trip_err}")
    ref = build_circular_flow(3, 2, hb, device="cpu", **A1_FLOW).double()
    params_from_jax(tree, ref)
    with torch.no_grad():
        lp64 = ref.log_prob(x[:check_points].cpu().double())
    d = (lp.cpu().double() - lp64).abs()
    lp_err = float(d.max())
    lp_rel = float((d / (1.0 + lp64.abs())).max())
    require(bool(torch.isfinite(lp).all()) and lp_rel <= FLOW_RTOL,
            f"log q on the card vs float64: {lp_err} ({lp_rel} relative)")

    # the flow's calls at ``chains``
    g = gen(4)
    pos, _ = init_alternating_wells(chains, 3, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 5,
                             0.65)
    x_old = (state.positions - hb).reshape(chains, 6)
    calls = {
        "sample_and_log_prob": lambda: flow.sample_and_log_prob(chains, g),
        "log_prob": lambda: flow.log_prob(x),
        "paired": lambda: flow.sample_and_log_prob_with_old(chains, x_old, g),
        "big_move_round": lambda: nf_big_moves(spec, 1.0, state, flow, hb, g),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            out[name] = {"ms": median_ms(fn), **per_call(fn)}

    # one training step at ``batch``
    cfg = TrainConfig(batch_size=batch)
    opt = make_optimizer(cfg)
    step = make_train_step(flow, cfg, opt)
    opt_state = [opt.init(list(flow.parameters()))]
    data = x[:batch].clone()

    def train_step():
        opt_state[0], loss = step(opt_state[0], data)
        return loss

    train_step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(loss)), f"training step loss {loss}")
    out["train_step"] = {"ms": median_ms(train_step, 5), **per_call(
        train_step, 1), "peak_mib": peak / 2 ** 20,
        "peak_over_base_mib": (peak - base) / 2 ** 20}
    for name, v in out.items():
        print(f"  {name}: " + " ".join(
            f"{k}={v[k]:.4f}" if isinstance(v[k], float) else f"{k}={v[k]}"
            for k in v), flush=True)
    phase("12 flow", card=f"'{card}'", chains=chains, batch=batch,
          identity_log_q_err=f"{id_err:.3g}", round_trip_err=f"{trip_err:.3g}",
          log_q_vs_float64_err=f"{lp_err:.3g}",
          log_q_vs_float64_rel=f"{lp_rel:.3g}",
          **{f"{k}_ms": f"{v['ms']:.3f}" for k, v in out.items()},
          **{f"{k}_kernels": v["kernels"] for k, v in out.items()},
          train_step_peak_mib=f"{out['train_step']['peak_mib']:.1f}")
    return out


# Phase 13's recipe: RESULTS.md's A1 at a short schedule
A1_SMOKE = dict(num_chains=64, epochs=2, big_move_attempts=100,
                big_move_interval=150, num_samples_for_analysis=5000)


def a1_schedule(config):
    """K1 and K2 launches of ``algorithm1.run``: K1 the equilibration
    blocks, one per Phase B sample, one per round; K2 the initial
    energies, one resync per sample, one per round."""
    eq_blocks, eq_rest = divmod(config.equilibration_steps,
                                config.adjusting_frequency)
    samples = config.initial_training_num_samples // config.num_chains
    rounds = config.big_move_attempts
    return (eq_blocks + (1 if eq_rest else 0) + samples + rounds,
            1 + samples + rounds)


def phase_algorithm1(card: str, **overrides) -> dict:
    """Algorithm 1 end to end through ``algorithm1.run`` at full width:
    K1 and K2 launch counts against the schedule (one of each per testing
    round), a finite final loss below the uniform flow's, big-move
    acceptance above 0, the JAX driver's result files without
    matplotlib, and each phase's wall time."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import algorithm1
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.utils.config import algorithm1_config

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        config = algorithm1_config(experiment_id="chip_smoke_a1",
                                   output_dir=out,
                                   **{**A1_SMOKE, **overrides})
        rounds = config.big_move_attempts
        expected = a1_schedule(config)
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        result = algorithm1.run(config, device=DEVICE)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = (cm.LAUNCHES, cp.LAUNCHES)
        d = result["directory"]
        nf = os.path.join("training_rounds", "initial_training_round")
        needed = ["params.json", "experiment.log", "metrics.jsonl",
                  "acceptance_rate_data.csv", "nf_acceptance_rate_data.json",
                  "avg_free_energy_data.json",
                  os.path.join(out, "evidence", "chip_smoke_a1_data.json")]
        if config.num_chains >= 10:
            needed.append("multi_avg_x_data.json")
        needed += [os.path.join(nf, f) for f in (
            "initial_model_circularspline_res_dense.pkl", "samples.npy",
            "loss_plot_data.json", "frequency_heatmap_data.json",
            "pair_correlation_function_data.json")]
        for i in range(config.num_chains):
            run_dir = os.path.join("mc_runs", f"run_{i + 1:03d}")
            needed.append(os.path.join(run_dir, "mc_run_testing_configs.npy"))
            if i < 10:
                needed += [os.path.join(run_dir, f) for f in (
                    "well_statistics_data.json",
                    f"avg_x_coordinate_run_{i + 1}_data.json")]
        missing = [f for f in needed if not os.path.exists(os.path.join(d, f))]
        require(not missing, f"missing A1 artifacts {missing[:5]}")
        acc_rows = np.loadtxt(os.path.join(d, "acceptance_rate_data.csv"),
                              delimiter=",", skiprows=1)
        testing = np.load(os.path.join(d, "mc_runs", "run_001",
                                       "mc_run_testing_configs.npy"))
        drawn = os.path.exists(os.path.join(d, "avg_free_energy.png"))
    require(launches == expected,
            f"A1 launched K1, K2 {launches} times, schedule implies "
            f"{expected}")
    loss = result["final_loss"]
    acc = result["big_move_acceptance"]
    # the loss leaves out the base's log q: the uniform flow's is 0, its
    # negative log-likelihood 6 log(2 half_box) = 13.82
    require(loss is not None and np.isfinite(loss) and loss < 0.0,
            f"final loss {loss} (the uniform flow's is 0)")
    require(acc > 0.0, f"big-move acceptance {acc}")
    require(acc_rows.shape == (rounds + 1, 2)
            and testing.shape == (rounds, 3, 2)
            and bool(np.isfinite(testing).all()),
            f"acceptance rows {acc_rows.shape}, testing configs "
            f"{testing.shape}")
    ph = result["phase_s"]
    phase("13 algorithm 1", card=f"'{card}'", chains=config.num_chains,
          samples=config.initial_training_num_samples,
          epochs=config.epochs, rounds=rounds,
          launches_k1=launches[0], expected_k1=expected[0],
          launches_k2=launches[1], expected_k2=expected[1],
          final_loss=f"{loss:.4f}", nll=f"{loss + 6 * np.log(10.0):.4f}",
          acceptance=f"{acc:.4f}",
          delta_f=f"{result['delta_f_mean']:.4f}+-{result['delta_f_sem']:.4f}",
          **{f"phase_{k}_s": f"{v:.2f}" for k, v in ph.items()},
          figures_drawn=drawn, wall_s=f"{wall_s:.2f}")
    return {"launches": launches[0], "launches_k2": launches[1],
            "phase_s": ph}


# Phase 14: Algorithm 2 at the reference's full width (100 chains, K=23,
# hidden 128, 15 bins, batch 256, 10 samples per chain a cycle), cut to
# 20 cycles with a checkpoint every 10
A2_CYCLES, A2_INTERVAL = 20, 5


def a2_schedule(config, cycles: int, resumed: bool = False):
    """K1 and K2 launches of ``cycles`` A2 cycles: K1 the equilibration
    blocks, one per initial sample (none on resume) and one per sample of
    a cycle; K2 the initial energies, one resync per sample, one big
    move's proposals per cycle (N // k blocked moves' with blocked_k)."""
    eq_blocks, eq_rest = divmod(config.equilibration_steps,
                                config.adjusting_frequency)
    c = config.num_chains
    initial = 0 if resumed else max(1, config.initial_training_num_samples
                                    // c)
    per = max(1, config.update_num_samples // c)
    moves = (max(1, config.num_particles // config.blocked_k)
             if config.blocked_k > 0 else 1)
    return (eq_blocks + (1 if eq_rest else 0) + initial + per * cycles,
            1 + initial + (per + moves) * cycles)


def same_state(a, b) -> bool:
    """Every field of two chain states bit-equal (NaN where NaN)."""
    import torch

    from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS

    return (a.seed, a.calls) == (b.seed, b.calls) and all(
        torch.equal(torch.nan_to_num(getattr(a, f), nan=7.0),
                    torch.nan_to_num(getattr(b, f), nan=7.0))
        for f in TENSOR_FIELDS)


def same_flow(a, b) -> bool:
    """Two flows' parameters bit-equal."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def phase_algorithm2(card: str, cycles: int = A2_CYCLES,
                     interval: int = A2_INTERVAL, **overrides) -> dict:
    """Algorithm 2 through ``algorithm2.run`` at full width, four times:
    (a) the host loop, ``cycles`` cycles: K1 and K2 launches against the
    schedule, checkpoints every ``2 interval`` cycles, the JAX driver's
    files without matplotlib, finite losses, an acceptance in (0, 1];
    (b) ``--resume`` in the same directory for 10 cycles more: the restored
    chain state and flow bit-equal to what (a) saved and ended with;
    (c) the fused runner with ``freeze_after = cycles / 2``: the flow
    bit-unchanged after the freeze, a frozen chunk's losses NaN,
    checkpoints on the chunk edges; (d) 3 cycles with ``alpha = 0.9``:
    the reverse-KLD term on the card, its loss and gradients finite.
    Prints ms per cycle by phase, the device kernels and peak memory of a
    training step at these widths, and each run's wall."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import algorithm2
    from flowstate_tpu_torch.experiments.common import build_system
    from flowstate_tpu_torch.flows import build_circular_flow, params_from_jax
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.training import make_optimizer, make_train_step
    from flowstate_tpu_torch.training.cycles import (
        make_fused_cycles, train_config,
    )
    from flowstate_tpu_torch.utils.checkpoint import (
        chain_state_from_tree, restore_checkpoint,
    )
    from flowstate_tpu_torch.utils.config import algorithm2_config

    def timed(**kw):
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        res = algorithm2.run(device=DEVICE, **kw)
        torch.cuda.synchronize()
        return res, (cm.LAUNCHES, cp.LAUNCHES), time.perf_counter() - t0

    def steps(directory):
        return sorted(os.listdir(os.path.join(directory, "checkpoints")))

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        def cfg(name, n, **kw):
            return algorithm2_config(experiment_id=name, output_dir=out,
                                     num_training_cycles=n,
                                     checkpoint_interval=interval,
                                     **{**overrides, **kw})

        # (a) the host loop
        config = cfg("chip_smoke_a2", cycles)
        c, n_part = config.num_chains, config.num_particles
        per = max(1, config.update_num_samples // c)

        def a2_flow():
            return build_circular_flow(
                n_part, 2, config.half_box, K=config.K,
                hidden_units=config.hidden_units, num_bins=config.num_bins,
                num_blocks=config.n_blocks, device=DEVICE)

        a, launches, wall_a = timed(config=config)
        expected = a2_schedule(config, cycles)
        require(launches == expected,
                f"A2 launched K1, K2 {launches} times, schedule implies "
                f"{expected}")
        d = a["directory"]
        saves = list(range(2 * interval, cycles + 1, 2 * interval))
        require(steps(d) == [f"step_{s:08d}" for s in saves],
                f"A2 checkpoints {steps(d)}")
        needed = ["params.json", "experiment.log", "metrics.jsonl",
                  "loss_plot_data.json", "production_positions.npy",
                  "p_acc_vs_training_samples_data.json",
                  "avg_free_energy_data.json",
                  os.path.join(out, "evidence", "chip_smoke_a2_data.json")]
        for s in saves:
            needed += [f"heatmap_cycle_{s}_data.json",
                       f"rdf_cycle_{s}_data.json",
                       os.path.join("checkpoints", f"step_{s:08d}", "tree.pt"),
                       os.path.join("checkpoints", f"step_{s:08d}",
                                    "metadata.json")]
        needed += [os.path.join("mc_runs", f"run_{i + 1:03d}",
                                "well_statistics_data.json")
                   for i in range(min(c, 10))]
        missing = [f for f in needed if not os.path.exists(os.path.join(d, f))]
        require(not missing, f"missing A2 artifacts {missing[:5]}")
        traj = np.load(os.path.join(d, "production_positions.npy"))
        require(traj.shape == (c, per * cycles, n_part, 2)
                and bool(np.isfinite(traj).all()),
                f"production positions {traj.shape}")
        losses = np.asarray(a["loss_per_cycle"])
        acc = a["big_move_acceptance"]
        require(len(losses) == config.epochs * (cycles + 1)
                and bool(np.isfinite(losses).all()), f"A2 losses {losses}")
        require(0.0 < acc <= 1.0, f"A2 acceptance {acc}")

        # (b) --resume: the saved state is what (a) ended with
        saved, meta = restore_checkpoint(os.path.join(
            d, "checkpoints", f"step_{saves[-1]:08d}"))
        require(meta["cycle"] == cycles, f"checkpoint metadata {meta}")
        back_state = chain_state_from_tree(saved["chains"], DEVICE)
        back_flow = params_from_jax(saved["flow"], a2_flow())
        require(same_state(back_state, a["state"]),
                "the restored chain state differs from the saved one")
        require(same_flow(back_flow, a["model"]),
                "the restored flow differs from the saved one")
        b, launches_b, wall_b = timed(config=cfg("chip_smoke_a2", cycles + 10),
                                      resume=True)
        expected_b = a2_schedule(config, 10, resumed=True)
        require(b["start_cycle"] == cycles and b["cycles_run"] == 10
                and launches_b == expected_b,
                f"resume: start {b['start_cycle']}, {b['cycles_run']} "
                f"cycles, launches {launches_b} (schedule {expected_b})")
        require(f"step_{cycles + 10:08d}" in steps(d), "no resumed checkpoint")

        # (c) fused, frozen after half the cycles
        freeze = cycles // 2
        c_cfg = cfg("chip_smoke_a2_fused", cycles)
        f, launches_c, wall_c = timed(config=c_cfg, fused=True,
                                      freeze_after=freeze)
        require(launches_c == expected,
                f"fused A2 launched {launches_c}, schedule implies "
                f"{expected}")
        edges, edge = [], 0          # chunks end at the freeze too
        while edge < cycles:
            n = min(2 * interval, cycles - edge)
            edge += min(n, freeze - edge) if edge < freeze else n
            edges.append(edge)
        require(steps(f["directory"]) == [f"step_{s:08d}" for s in edges],
                f"fused checkpoints {steps(f['directory'])}, chunk edges "
                f"{edges}")
        frozen = [params_from_jax(restore_checkpoint(os.path.join(
            f["directory"], "checkpoints", f"step_{s:08d}"))[0]["flow"],
            a2_flow()) for s in (freeze, cycles)]
        require(same_flow(frozen[0], frozen[1])
                and same_flow(frozen[1], f["model"]),
                "the flow changed after the freeze")
        require(len(f["loss_per_cycle"]) == config.epochs * (freeze + 1),
                f"fused losses {len(f['loss_per_cycle'])}")
        spec = build_system(c_cfg)
        _, out_frozen = make_fused_cycles(f["model"], spec, c_cfg, 1,
                                          train=False)(f["state"], cycles)
        require(bool(torch.isnan(out_frozen["loss"]).all())
                and same_flow(frozen[1], f["model"]),
                "a frozen chunk trained the flow or gave finite losses")

        # (d) the mixed loss on the card
        m, _, wall_d = timed(config=cfg("chip_smoke_a2_alpha", 3, alpha=0.9))
        g = torch.Generator(device=DEVICE)
        g.manual_seed(7)
        rkld, _ = m["model"].reverse_kld(256, g)
        grads = torch.autograd.grad(rkld, list(m["model"].parameters()))
        rkld = rkld.detach()
        require(bool(np.isfinite(m["loss_per_cycle"]).all())
                and bool(torch.isfinite(rkld))
                and all(bool(torch.isfinite(x).all()) for x in grads),
                f"alpha=0.9: losses {m['loss_per_cycle']}, reverse KLD "
                f"{float(rkld)}")

    # a training step at these widths: device kernels and peak memory
    flow = a2_flow()
    cfg_step = train_config(config)
    opt = make_optimizer(cfg_step)
    step = make_train_step(flow, cfg_step, opt)
    opt_state = [opt.init(list(flow.parameters()))]
    batch = torch.as_tensor(traj.reshape(-1, 2 * n_part)[-config.batch_size:]
                            - config.half_box, device=DEVICE)

    def train_step():
        opt_state[0], loss = step(opt_state[0], batch)
        return loss

    train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    train = {"ms": median_ms(train_step, 5), **per_call(train_step, 1)}
    ph = a["phase_s"]
    ms = {k: 1e3 * ph[k] / cycles
          for k in ("production", "training", "big_move", "evaluation")}
    phase("14 algorithm 2", card=f"'{card}'", chains=c, K=config.K,
          hidden=config.hidden_units, bins=config.num_bins, cycles=cycles,
          launches_k1=launches[0], expected_k1=expected[0],
          launches_k2=launches[1], expected_k2=expected[1],
          acceptance=f"{acc:.4f}", final_loss=f"{losses[-1]:.4f}",
          resumed_launches=f"{launches_b[0]},{launches_b[1]}",
          fused_launches=f"{launches_c[0]},{launches_c[1]}",
          fused_acceptance=f"{f['big_move_acceptance']:.4f}",
          alpha09_loss=f"{m['loss_per_cycle'][-1]:.4f}",
          reverse_kld=f"{float(rkld):.4f}",
          **{f"{k}_ms_per_cycle": f"{v:.2f}" for k, v in ms.items()},
          train_step_ms=f"{train['ms']:.3f}",
          train_step_kernels=train["kernels"],
          train_step_device_ms=(None if train["device_ms"] is None
                                else f"{train['device_ms']:.3f}"),
          train_step_peak_mib=f"{peak / 2 ** 20:.1f}",
          wall_host_s=f"{wall_a:.2f}", wall_resume_s=f"{wall_b:.2f}",
          wall_fused_s=f"{wall_c:.2f}", wall_alpha_s=f"{wall_d:.2f}")
    return {"launches": launches[0], "launches_k2": launches[1],
            "ms_per_cycle": ms, "train_step": train, "peak": peak}


# Phase 15: the blocked moves at the reference bench's width (bench.py:
# 338-385): N=8, k=1, the conditional flow at K=6, hidden 128, 16 bins,
# the Fourier context to m_max=3 (98 features), 16,384 chains
BLOCKED_FLOW = dict(K=6, hidden_units=128, num_bins=16)
BLOCKED_N, BLOCKED_MODES = 8, 3
# Algorithm 1 and 2 with blocked_k=1 at those widths, cut to 64 chains
BLOCKED_A1 = dict(num_particles=8, blocked_k=1, blocked_K=6,
                  hidden_units=128, num_bins=16, num_chains=64, epochs=1,
                  batch_size=512, initial_training_num_samples=64 * 32,
                  big_move_attempts=20, big_move_interval=150,
                  num_samples_for_analysis=1000)
BLOCKED_A2 = dict(num_particles=8, blocked_k=1, blocked_K=6,
                  hidden_units=128, num_bins=16, num_chains=64, epochs=1,
                  batch_size=256, initial_training_num_samples=640,
                  update_num_samples=640, equilibration_steps=2000,
                  adjusting_frequency=1000, checkpoint_interval=1,
                  num_samples_for_analysis=1000,
                  num_samples_for_free_energy=40)
BLOCKED_A2_CYCLES = 4
# the paired pass against the separate ones, in float32: six spline
# layers, each fed the last, with the nets' products batched in one and
# not in the other, part by a few ulps of the box (16.3 wide: an ulp is
# 1.9e-6)
BLOCKED_POS_ATOL = 1e-4


def perturbed_tree(flow, seed: int):
    """A numpy tree in the JAX layout of ``flow``'s parameters, far from
    the identity init: each linear's ``w`` N(0, 0.5 / sqrt(fan_in)), its
    ``b`` N(0, 0.1), the unconditional splines' parameters N(0, 0.3)."""
    import numpy as np

    from flowstate_tpu_torch.flows import params_to_jax

    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        if name == "w":
            return rng.normal(0.0, 0.5 / np.sqrt(tree.shape[-2]), tree.shape)
        return rng.normal(0.0, 0.1 if name == "b" else 0.3, tree.shape)

    return walk(params_to_jax(flow))


def phase_blocked(card: str, chains: int = 16384, a1: dict = None,
                  a2: dict = None, a2_cycles: int = BLOCKED_A2_CYCLES
                  ) -> dict:
    """The blocked moves on the card.  (a) At the bench's width with a
    perturbed flow: the paired and the separate passes make the same
    proposals and the same decisions (R2), K2's proposal energies against
    its plain version, rejected chains bit-unchanged; ms per blocked move
    by CUDA events, device kernels, device ms and the idle share by the
    profiler, peak memory, blocked moves per second.  (b) Algorithm 1 with
    ``blocked_k=1`` through ``algorithm1.run``: K1 and K2 launches against
    the schedule (one K1 and N // k K2 per round), a finite loss,
    acceptance in (0, 1], ``df_particle`` and the sector counts.  (c)
    Algorithm 2's host loop with ``blocked_k=1``: launches against the
    schedule, a resume from the mid-run checkpoint bit-equal to the
    uninterrupted run, ``fused=True`` refused."""
    import shutil

    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import algorithm1, algorithm2
    from flowstate_tpu_torch.flows import (
        build_conditional_circular_flow, params_from_jax,
    )
    from flowstate_tpu_torch.mcmc import blocked as mb
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import (
        init_chain_state, resync_energy, run_moves_auto,
    )
    from flowstate_tpu_torch.mcmc.initialise import init_split_wells
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.training import (
        Adam, blocked_pairs, make_blocked_train_step,
    )
    from flowstate_tpu_torch.utils.config import (
        algorithm1_config, algorithm2_config,
    )

    # (a) the bench's width -------------------------------------------
    n, k = BLOCKED_N, 1
    spec = reference_spec(n)
    hb = spec.box.size_x / 2.0
    g = torch.Generator(device=DEVICE)
    g.manual_seed(21)
    flow = build_conditional_circular_flow(
        k, 2, hb, context_features=mb.fourier_context_dim(BLOCKED_MODES),
        generator=g, device=DEVICE, **BLOCKED_FLOW)
    params_from_jax(perturbed_tree(flow, 22), flow)

    def context_fn(rest, positions):
        return mb.fourier_context(rest, positions, hb, BLOCKED_MODES)

    pos, _ = init_split_wells(chains, n, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 23,
                             0.65)
    state = resync_energy(spec, run_moves_auto(spec, 1.0, state, 200))
    perm = mb.random_block_perm(chains, n, g, DEVICE)
    z = flow.base_sample(chains, g)
    u = torch.rand(chains, generator=g, device=DEVICE)
    with torch.no_grad():
        moves = [mb.apply_blocked_moves(spec, 1.0, state, perm, z, u, flow,
                                        hb, k, context_fn, paired=p)
                 for p in (True, False)]
        ctx = context_fn(perm[:, k:], state.positions)
        old = (mb.select_particles(perm[:, :k], state.positions)
               - hb).reshape(chains, -1)
        props, lq = [], []
        for p in (True, False):
            new, lq_new, lq_old = flow.push_forward_with_old(z, old, ctx, p)
            props.append(mb.scatter_block(
                perm[:, :k], new.reshape(chains, k, 2) + hb,
                state.positions))
            lq.append((lq_new, lq_old))
    res = moves[0]
    prop_err = float((props[0] - props[1]).abs().max())
    lq_err = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                 for a, b in zip(lq[0], lq[1]))
    require(prop_err <= BLOCKED_POS_ATOL and lq_err <= FLOW_RTOL,
            f"paired vs separate passes: proposals {prop_err}, log q "
            f"{lq_err} relative")
    # the move's energies are K2's on these proposals, and K2 holds to
    # its plain version on them
    for m, q in zip(moves, props):
        e_k, _ = cp.total_energy_virial_kernel(spec, q)
        require(torch.equal(m.proposal_energy, e_k),
                "the move's proposal energies are not K2's")
    e_plain, _ = cp.total_energy_virial_plain(spec, props[0])
    pair_err = compare_pair(spec, props[0], "blocked proposals",
                            overlaps=torch.nonzero(torch.isinf(
                                e_plain)).flatten().tolist())
    # R2: the decisions follow the ratios; the two passes' decisions differ
    # only where u lies between their acceptance probabilities
    p0, p1 = (torch.exp(m.ratio_log) for m in moves)
    require(all(torch.equal(m.accepted, u < torch.exp(m.ratio_log))
                for m in moves), "accept flags do not follow the ratios")
    near = ((torch.minimum(p0, p1) - NEAR_TIE <= u)
            & (u <= torch.maximum(p0, p1) + NEAR_TIE))
    differ = moves[0].accepted != moves[1].accepted
    require(not bool((differ & ~near).any()),
            f"paired and separate passes decide {int(differ.sum())} chains "
            f"differently, {int((differ & ~near).sum())} not near a tie")
    rej = ~res.accepted
    require(torch.equal(res.state.positions[rej], state.positions[rej])
            and torch.equal(res.state.energy[rej], state.energy[rej]),
            "a rejected chain moved")
    acc_a = float(res.accepted.float().mean())
    require(0.0 < acc_a < 1.0, f"bench-width acceptance {acc_a}")
    require(not bool(torch.isnan(res.ratio_log).any()), "NaN log-ratio")

    def one_move():
        return mb.blocked_big_moves(spec, 1.0, state, flow, hb, k, g,
                                    context_fn)

    ms = median_ms(one_move, 7)
    prof = per_call(one_move, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one_move()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    idle = (None if prof["device_ms"] is None
            else 1.0 - prof["device_ms"] / ms)
    bench = {"ms": ms, **prof, "idle_share": idle,
             "peak_mib": peak / 2 ** 20,
             "peak_over_base_mib": (peak - base) / 2 ** 20,
             "blocked_moves_per_s": chains / (ms / 1e3),
             "acceptance": acc_a}

    # a conditional training step at batch 512, at this depth and at the
    # recipe's K=10, on blocks cut from the chains
    steps = {}
    for depth in (BLOCKED_FLOW["K"], 10):
        f = build_conditional_circular_flow(
            k, 2, hb, context_features=mb.fourier_context_dim(BLOCKED_MODES),
            generator=g, device=DEVICE, **{**BLOCKED_FLOW, "K": depth})
        params_from_jax(perturbed_tree(f, 24), f)
        adam = Adam(1e-4)
        step = make_blocked_train_step(f, adam)
        opt_state = [adam.init(list(f.parameters()))]
        batch = blocked_pairs(g, state.positions[:512], k, hb, context_fn)

        def train_step():
            opt_state[0], loss = step(opt_state[0], batch)
            return loss

        require(bool(torch.isfinite(train_step())),
                "blocked training step: non-finite loss")
        steps[depth] = {"ms": median_ms(train_step, 5),
                        **per_call(train_step, 1)}

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        # (b) Algorithm 1 -----------------------------------------------
        cfg1 = algorithm1_config(experiment_id="chip_smoke_blocked_a1",
                                 output_dir=out, **(a1 or BLOCKED_A1))
        bpr = max(1, cfg1.num_particles // cfg1.blocked_k)
        eq_blocks, eq_rest = divmod(cfg1.equilibration_steps,
                                    cfg1.adjusting_frequency)
        samples = cfg1.initial_training_num_samples // cfg1.num_chains
        rounds = cfg1.big_move_attempts
        expected1 = (eq_blocks + (1 if eq_rest else 0) + samples + rounds,
                     1 + samples + bpr * rounds)
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        r1 = algorithm1.run(cfg1, device=DEVICE)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        launches1 = (cm.LAUNCHES, cp.LAUNCHES)
        require(launches1 == expected1,
                f"blocked A1 launched K1, K2 {launches1} times, schedule "
                f"implies {expected1}")
        with open(os.path.join(out, "evidence",
                               "chip_smoke_blocked_a1_data.json")) as f:
            ev1 = json.load(f)
        loss1, acc1 = r1["final_loss"], r1["big_move_acceptance"]
        require(loss1 is not None and np.isfinite(loss1)
                and 0.0 < acc1 <= 1.0 and np.isfinite(r1["df_particle"])
                and sum(v for key, v in ev1["sector_counts"].items()
                        if key != "burn_frac") > 0
                and os.path.exists(os.path.join(
                    r1["directory"], "training_rounds",
                    "initial_training_round",
                    "initial_model_blocked_conditional.pkl")),
                f"blocked A1: loss {loss1}, acceptance {acc1}, df_particle "
                f"{r1['df_particle']}, sectors {ev1['sector_counts']}")

        # (c) Algorithm 2's host loop -----------------------------------
        cfg2 = algorithm2_config(experiment_id="chip_smoke_blocked_a2",
                                 output_dir=out, num_training_cycles=a2_cycles,
                                 **(a2 or BLOCKED_A2))
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        r2 = algorithm2.run(cfg2, device=DEVICE)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches2 = (cm.LAUNCHES, cp.LAUNCHES)
        expected2 = a2_schedule(cfg2, a2_cycles)
        require(launches2 == expected2,
                f"blocked A2 launched K1, K2 {launches2} times, schedule "
                f"implies {expected2}")
        acc2 = r2["big_move_acceptance"]
        require(0.0 < acc2 <= 1.0
                and bool(np.isfinite(r2["loss_per_cycle"]).all()),
                f"blocked A2: acceptance {acc2}, losses "
                f"{r2['loss_per_cycle']}")
        # resume from the mid-run checkpoint to the end: bit-equal
        mid = a2_cycles // 2
        ckpts = os.path.join(r2["directory"], "checkpoints")
        for name in os.listdir(ckpts):
            if int(name[5:]) > mid:
                shutil.rmtree(os.path.join(ckpts, name))
        cm.LAUNCHES = cp.LAUNCHES = 0
        r3 = algorithm2.run(cfg2, resume=True, device=DEVICE)
        torch.cuda.synchronize()
        launches3 = (cm.LAUNCHES, cp.LAUNCHES)
        expected3 = a2_schedule(cfg2, a2_cycles - mid, resumed=True)
        require(r3["start_cycle"] == mid and launches3 == expected3,
                f"blocked A2 resume: start {r3['start_cycle']}, launches "
                f"{launches3} (schedule {expected3})")
        require(same_state(r3["state"], r2["state"])
                and same_flow(r3["model"], r2["model"]),
                "the resumed blocked A2 run differs from the uninterrupted "
                "one")
        try:
            algorithm2.run(cfg2, fused=True, device=DEVICE)
        except ValueError as e:
            require("host-driven" in str(e), f"fused blocked A2: {e}")
        else:
            raise AssertionError("fused blocked A2 did not raise")

    print("  bench: " + " ".join(
        f"{key}={v:.4f}" if isinstance(v, float) else f"{key}={v}"
        for key, v in bench.items()), flush=True)
    phase("15 blocked moves", card=f"'{card}'", chains=chains, n=n, k=k,
          K=BLOCKED_FLOW["K"], hidden=BLOCKED_FLOW["hidden_units"],
          bins=BLOCKED_FLOW["num_bins"], acceptance=f"{acc_a:.4f}",
          proposal_err=f"{prop_err:.3g}", log_q_rel_err=f"{lq_err:.3g}",
          pair_err=f"{pair_err:.3g}",
          decisions_differ=int(differ.sum()),
          ms_per_move=f"{ms:.3f}", kernels_per_move=prof["kernels"],
          device_ms_per_move=(None if prof["device_ms"] is None
                              else f"{prof['device_ms']:.3f}"),
          idle_share=None if idle is None else f"{idle:.3f}",
          peak_mib=f"{bench['peak_mib']:.1f}",
          blocked_moves_per_s=f"{bench['blocked_moves_per_s']:.1f}",
          **{f"train_step_K{d}_ms": f"{v['ms']:.3f}" for d, v in
             steps.items()},
          **{f"train_step_K{d}_kernels": v["kernels"] for d, v in
             steps.items()},
          **{f"train_step_K{d}_device_ms": (
              None if v["device_ms"] is None else f"{v['device_ms']:.3f}")
             for d, v in steps.items()},
          a1_launches=f"{launches1[0]},{launches1[1]}",
          a1_loss=f"{loss1:.4f}", a1_acceptance=f"{acc1:.4f}",
          a1_df_particle=f"{r1['df_particle']:.4f}",
          a1_phase_s=",".join(f"{key}:{v:.2f}"
                              for key, v in r1["phase_s"].items()),
          a1_wall_s=f"{wall1:.2f}",
          a2_launches=f"{launches2[0]},{launches2[1]}",
          a2_resumed_launches=f"{launches3[0]},{launches3[1]}",
          a2_acceptance=f"{acc2:.4f}", a2_wall_s=f"{wall2:.2f}")
    return {"bench": bench, "train_step": steps, "launches_a1": launches1,
            "launches_a2": launches2, "max_abs_err": pair_err}


# Phase 16: the other samplers.  (a) K1 with a beta per chain at 16,384
# chains, N=3 and N=8, two betas alternating by chain; (b) TEMPERING.md's full run
# through the PT driver: N=3, 256 walkers x 10 replicas, T 1 to 10
# geometric, 3000 rounds of 50 moves (38,400,000 cold-replica moves) in
# segments of 600; (c) MALA and HMC; (d) the NPZ trainer at A1's widths
PT_RUN = dict(num_chains=256, pt_replicas=10, pt_moves_per_round=50,
              pt_segment_rounds=600)
PT_STEPS = 38_400_000
PT_EXACT_DF = 1.490          # tools/exact_free_energy.py
PT_DF_SEMS = 3               # the cold ΔF within 3 of its SEMs of 1.490
# the JAX driver's run of the same command (results/evidence/
# pt_n3_r5_data.json, TPU v5e)
PT_JAX = {"delta_f": "1.4684+-0.0338", "df_particle_mbar": "0.4028+-0.0071",
          "df_sector_mbar": 1.5486}
# the tracked energy against a recompute after a segment's 30,000 moves:
# a float32 running sum of some 10^4 accepted changes of order 1 rounds by
# about sqrt(10^4) * 4e-6 = 4e-4
PT_DRIFT_BOUND = 1e-2
# MALA and HMC at the reference preset (mcmc_only_config: 100 chains,
# N=3), the production budget cut from 10^7 to 10 samples a chain
SAMPLER_STEPS = 100 * 150 * 10
# the gradient against central differences in float64, step 1e-5: the
# truncation h^2 |U'''| / 6 and the rounding 1e-16 |U| / h stay below
# 1e-6 of |g| + 1 at these configurations
GRAD_FD_STEP, GRAD_FD_RTOL = 1e-5, 1e-6


def pt_schedule(config, total_steps: int, start_segment: int = 0):
    """K1 and K2 launches of a PT driver run: K1 the equilibration blocks
    (none on resume) and one per round; K2 the initial energies (none on
    resume) and one drift check per segment."""
    from flowstate_tpu_torch.experiments.tempering import schedule

    seg_len, segments = schedule(config, total_steps)
    run = segments - start_segment
    if start_segment:
        return seg_len * run, run
    eq_blocks, eq_rest = divmod(config.equilibration_steps,
                                config.adjusting_frequency)
    return eq_blocks + (1 if eq_rest else 0) + seg_len * run, 1 + run


def exact_n1_delta_f():
    """The N=1 double well of phase 5 and its quadrature ΔF."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.ops import Box, SystemSpec, double_well_potential

    spec = SystemSpec.create(1, Box.from_density(1, 0.01, 1.0), num_wells=2,
                             V0_list=(-2.0, -2.5), r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], -1),
                          dtype=torch.float32)
    v = double_well_potential(pts, lx, ly, V0_list=list(spec.V0_list),
                              r0=spec.r0, k=spec.k).numpy().reshape(g, g)
    w = np.exp(-v)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    in_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    return spec, float(np.log(w[in_b].sum() / w[in_a].sum()))


def phase_samplers(card: str, chains: int = 16384, pt: dict = None,
                   pt_steps: int = PT_STEPS,
                   sampler_steps: int = SAMPLER_STEPS,
                   n1_chains: int = 4096, npz_rows: int = 20480,
                   train_widths: dict = None) -> dict:
    """Parallel tempering, MALA, HMC and the NPZ trainer on the card.

    (a) K1 with a (C,) beta at N=3 and N=8, two betas alternating by
    chain, against two launches at each scalar beta on the same chains
    (positions, energies and counts bit-equal), and against its plain
    version on injected tables; one device kernel per call with the tensor
    and with a float.
    (b) ``experiments.tempering.run`` at TEMPERING.md's width, straight and
    as two segments then ``resume=True``: the final states and every
    ``seg_*.npz`` bit-equal, K1 and K2 launches equal to the schedule, the
    drift of the tracked energy at every segment's end, the cold ΔF within
    3 SEM of 1.490; ms, device kernels, device ms and the idle share per
    round.  (c) MALA and HMC: the N=1 ΔF against the quadrature, the
    gradient against central differences in float64, ``mcmc_only`` with
    each at the reference preset (the budget cut), launches, acceptance,
    ms per move and per trajectory.  (d) ``train_npz`` on the PT run's
    cold configurations at A1's widths, one epoch."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import (
        mcmc_only, tempering, train_npz,
    )
    from flowstate_tpu_torch.experiments.common import build_system
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import (
        init_alternating_wells, init_chain_state, resync_energy, run_hmc,
        run_hmc_equilibration, run_mala, run_mala_equilibration,
    )
    from flowstate_tpu_torch.mcmc.mala import potential_gradient
    from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS
    from flowstate_tpu_torch.mcmc.tempering import temperature_ladder
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.ops.pair_energy import total_energy_virial
    from flowstate_tpu_torch.tools.tempering_check import profile_rounds
    from flowstate_tpu_torch.utils.config import (
        mcmc_only_config, tempering_config,
    )

    # (a) K1 with a beta per chain, at N=3 (4-lane groups) and N=8 (8-lane
    # groups, PT's N=8 runs) ----------------------------------------------
    two = torch.tensor([1.0, 0.4], device=DEVICE)
    beta_c = two.repeat(chains // 2 + 1)[:chains].contiguous()
    even = torch.arange(chains, device=DEVICE) % 2 == 0
    beta_checks = {}
    for n_a in (3, 8):
        spec = reference_spec(n_a)
        pos, _ = init_alternating_wells(chains, n_a, 0.03)
        state = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE),
                                 31, 0.65)
        mixed = cm.run_moves_kernel(spec, beta_c, state, 200)
        cold = cm.run_moves_kernel(spec, 1.0, state, 200)
        hot = cm.run_moves_kernel(spec, 0.4, state, 200)
        torch.cuda.synchronize()
        for f in ("positions", "energy", "accepts", "attempts"):
            want = torch.where(even.reshape((-1,) + (1,) * (getattr(
                mixed, f).ndim - 1)), getattr(cold, f), getattr(hot, f))
            require(torch.equal(getattr(mixed, f), want),
                    f"K1 with a beta per chain at N={n_a}: {f} differs from "
                    "the launches at each scalar beta")
        acc_cold = float((cold.accepts - state.accepts)[even].float()
                         .mean()) / 200
        acc_hot = float((hot.accepts - state.accepts)[~even].float()
                        .mean()) / 200
        require(acc_cold < acc_hot, f"N={n_a}: acceptance at beta 1 "
                f"{acc_cold} not below beta 0.4's {acc_hot}")
        err = compare_pathwise(spec, state, 128, 32,
                               f"beta per chain, N={n_a}", beta=beta_c)
        beta_checks[n_a] = (acc_cold, acc_hot, err)
    err_a = max(v[2] for v in beta_checks.values())
    # the wrapper launches K1 once a call, and every device kernel the
    # profiler records for the calls is K1 (a fill or copy for the beta
    # would show under its own name), no more than one a call; the
    # profiler loses records (6 and 4 of 20 with a tensor in two runs, 20
    # in a third; F6), so its count may fall short of the calls, but it
    # must record some: a window with none is profiled once more
    calls = 100
    kernels = {}
    for label, beta in (("tensor", beta_c), ("float", 1.0)):
        for _ in range(2):
            before = cm.LAUNCHES
            events = device_kernels(
                lambda beta=beta: cm.run_moves_kernel(spec, beta, state, 50),
                calls)
            require(cm.LAUNCHES - before == calls + 1,   # and one warm-up
                    f"{calls} calls with a {label} beta: "
                    f"{cm.LAUNCHES - before - 1} K1 launches")
            if events:
                break
        names = sorted({e.name for e in events})
        require(events and len(events) <= calls and len(names) == 1
                and "metropolis_moves_kernel" in names[0],
                f"{calls} calls with a {label} beta ran {len(events)} "
                f"device kernels: {names[:6]}")
        kernels[label] = len(events)

    # (b) TEMPERING.md's run through the driver ----------------------------
    pt = pt or PT_RUN
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        cfg_a = tempering_config(experiment_id="pt_straight",
                                 output_dir=out, **pt)
        expected = pt_schedule(cfg_a, pt_steps)
        cm.LAUNCHES = cp.LAUNCHES = 0
        t0 = time.perf_counter()
        ra = tempering.run(cfg_a, pt_steps, device=DEVICE)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches = (cm.LAUNCHES, cp.LAUNCHES)
        require(launches == expected,
                f"PT launched K1, K2 {launches} times, schedule {expected}")
        seg_len = cfg_a.pt_segment_rounds
        cfg_b = tempering_config(experiment_id="pt_resumed", output_dir=out,
                                 **pt)
        part_steps = 2 * seg_len * cfg_b.pt_moves_per_round * cfg_b.num_chains
        cm.LAUNCHES = cp.LAUNCHES = 0
        rb = tempering.run(cfg_b, part_steps, device=DEVICE)
        part = (cm.LAUNCHES, cp.LAUNCHES)
        cm.LAUNCHES = cp.LAUNCHES = 0
        rc = tempering.run(cfg_b, pt_steps, resume=True, device=DEVICE)
        torch.cuda.synchronize()
        resumed = (cm.LAUNCHES, cp.LAUNCHES)
        want = (pt_schedule(cfg_b, part_steps),
                pt_schedule(cfg_b, pt_steps, start_segment=2))
        require((part, resumed) == want,
                f"PT in two parts launched K1, K2 {part} and {resumed} "
                f"times, schedule {want}")
        require(same_state(rc["state"], ra["state"]),
                "the resumed PT run's final state differs from the "
                "uninterrupted one's")
        seg_a = os.path.join(ra["directory"], "segments")
        seg_c = os.path.join(rc["directory"], "segments")
        names = sorted(os.listdir(seg_a))
        require(names == sorted(os.listdir(seg_c)) and len(names)
                == ra["rounds"] // seg_len, f"segments {names}")
        for name in names:
            a = np.load(os.path.join(seg_a, name))
            c = np.load(os.path.join(seg_c, name))
            require(a.files == c.files and all(
                np.array_equal(a[k], c[k]) for k in a.files),
                f"{name} differs between the straight and resumed runs")
        drift = ra["energy_drift"]
        require(all(np.isfinite(d) and d < PT_DRIFT_BOUND for d in drift),
                f"tracked energy drift {drift}")
        df, sem = ra["delta_f_mean"], ra["delta_f_sem"]
        require(sem > 0 and abs(df - PT_EXACT_DF) <= PT_DF_SEMS * sem,
                f"PT cold ΔF {df} +- {sem} vs exact {PT_EXACT_DF}")
        require(min(ra["edge_acceptance"]) > 0.05,
                f"edge acceptance {ra['edge_acceptance']}")
        cold_pos = np.load(os.path.join(seg_a, names[-1]))["cold_positions"]

        # the round's cost, from a profiled window at the run's shape
        cfg = cfg_a
        pt_spec = build_system(cfg)
        betas = temperature_ladder(cfg.temperature, cfg.pt_t_hot,
                                   cfg.pt_replicas, cfg.pt_ladder, DEVICE)
        timing = profile_rounds(
            pt_spec, betas, ra["state"],
            torch.Generator(device=DEVICE).manual_seed(5),
            cfg.pt_moves_per_round, tempering.well_record(cfg))

        # (d) the NPZ trainer on the run's cold configurations -----------
        rows = cold_pos.reshape(-1, 3, 2)[-npz_rows:] - cfg.half_box
        npz = os.path.join(out, "pt_cold.npz")
        np.savez(npz, configs=rows)
        widths = train_widths or dict(K=15, hidden_units=256, num_bins=32)
        t0 = time.perf_counter()
        tn = train_npz.main([
            "--npz_path", npz, "--output_path", os.path.join(out, "npz"),
            "--half_box", str(cfg.half_box), "--K", str(widths["K"]),
            "--hidden_units", str(widths["hidden_units"]),
            "--num_bins", str(widths["num_bins"]), "--epochs", "1",
            "--eval_samples", "20000", "--device", DEVICE])
        wall_npz = time.perf_counter() - t0
        written = set(os.listdir(os.path.join(out, "npz")))
        require(np.isfinite(tn["final_loss"]) and tn["num_samples"] > 0
                and {"trained_model.pkl", "frequency_heatmap_data.json",
                     "pair_correlation_function_data.json"} <= written,
                f"train_npz: loss {tn['final_loss']}, {tn['num_samples']} "
                f"samples, files {sorted(written)}")

        # (c) MALA and HMC through mcmc_only --------------------------------
        drivers = {}
        for sampler in ("mala", "hmc"):
            cfg_s = mcmc_only_config(experiment_id=f"chip_smoke_{sampler}",
                                     sampler=sampler, output_dir=out)
            samples = (sampler_steps // cfg_s.num_chains
                       // cfg_s.sampling_frequency)
            per_block = (cfg_s.sampling_frequency if sampler == "mala"
                         else max(1, cfg_s.sampling_frequency
                                  // cfg_s.num_leapfrog))
            adapt = 1000 if sampler == "mala" else 500
            eq_blocks, eq_rest = divmod(cfg_s.equilibration_steps,
                                        cfg_s.adjusting_frequency)
            want = (eq_blocks + (1 if eq_rest else 0),
                    2 + adapt + samples * per_block)
            cm.LAUNCHES = cp.LAUNCHES = 0
            t0 = time.perf_counter()
            res = mcmc_only.run(cfg_s, sampler_steps, device=DEVICE)
            torch.cuda.synchronize()
            got = (cm.LAUNCHES, cp.LAUNCHES)
            require(got == want, f"mcmc_only --sampler {sampler} launched "
                    f"K1, K2 {got} times, schedule {want}")
            acc = res["production_acceptance"]
            require(0.2 < acc < 0.95 and np.isfinite(
                res["energy_per_particle"]),
                f"{sampler}: acceptance {acc}, E/N "
                f"{res['energy_per_particle']}")
            drivers[sampler] = {"launches": got, "acceptance": acc,
                                "e_per_particle": res["energy_per_particle"],
                                "wall_s": time.perf_counter() - t0}

    # ms per MALA move and per HMC trajectory at the preset's 100 chains
    spec3 = reference_spec(3)
    pos, _ = init_alternating_wells(100, 3, 0.03)
    s100 = resync_energy(spec3, cm.run_moves_kernel(
        spec3, 1.0, init_chain_state(spec3, torch.as_tensor(
            pos, device=DEVICE), 3, 0.65), 2000))
    mala_ms = cuda_ms(lambda: run_mala(spec3, 1.0, s100.replace(
        max_disp=torch.full_like(s100.max_disp, 0.02)), 20), 3) / 20
    hmc_ms = cuda_ms(lambda: run_hmc(spec3, 1.0, s100.replace(
        max_disp=torch.full_like(s100.max_disp, 0.05)), 5), 3) / 5

    # the N=1 ΔF against the quadrature, each sampler
    spec1, exact = exact_n1_delta_f()
    lx, ly = spec1.box.size_x, spec1.box.size_y
    radius = 1.1 * spec1.r0
    n1 = {}
    for sampler in ("mala", "hmc"):
        pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (n1_chains, 1, 1))
        pos0[n1_chains // 2:, :, 0] = 3 * lx / 4
        s = init_chain_state(spec1, torch.as_tensor(pos0, device=DEVICE), 7,
                             0.3)
        frames = []
        if sampler == "mala":
            s = run_mala_equilibration(spec1, 1.0, s, 300, 50)
            for _ in range(120):
                s = run_mala(spec1, 1.0, s, 5)
                frames.append(s.positions)
        else:
            s = run_hmc_equilibration(spec1, 1.0, s, 200, 25, 5)
            for _ in range(120):
                s = run_hmc(spec1, 1.0, s, 3, 5)
                frames.append(s.positions)
        xy = torch.stack(frames).reshape(-1, 2).cpu().numpy()
        sa = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
        sb = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
        n1[sampler] = float(np.log(sb.sum() / sa.sum()))
        require(abs(n1[sampler] - exact) < 0.12,
                f"{sampler} N=1 ΔF {n1[sampler]} vs exact {exact}")

    # the gradient against central differences, float64 on the card
    g64 = torch.Generator(device=DEVICE).manual_seed(41)
    x = (init_chain_state(spec3, torch.as_tensor(
        pos[:64], device=DEVICE), 3, 0.65).positions.double()
         + 0.2 * torch.randn((64, 3, 2), generator=g64, device=DEVICE,
                             dtype=torch.float64))
    grad = potential_gradient(spec3, x)
    fd = torch.zeros_like(x)
    for i in range(3):
        for d in range(2):
            step = torch.zeros_like(x)
            step[:, i, d] = GRAD_FD_STEP
            fd[:, i, d] = ((total_energy_virial(spec3, x + step)[0]
                            - total_energy_virial(spec3, x - step)[0])
                           / (2 * GRAD_FD_STEP))
    grad_err = float(((grad - fd).abs() / (grad.abs() + 1.0)).max())
    require(grad.dtype == torch.float64 and grad_err <= GRAD_FD_RTOL,
            f"gradient against central differences: {grad_err} relative")

    rounds = ra["rounds"]
    phase("16 samplers", card=f"'{card}'",
          beta_per_chain="bit-equal at N=3 and N=8",
          pathwise_err=",".join(f"{v[2]:.3g}" for v in beta_checks.values()),
          k1_calls_profiled=calls,
          kernels_recorded_tensor=kernels["tensor"],
          kernels_recorded_float=kernels["float"],
          kernel_names_recorded="metropolis_moves_kernel",
          acceptance_beta1=",".join(f"{v[0]:.4f}"
                                    for v in beta_checks.values()),
          acceptance_beta04=",".join(f"{v[1]:.4f}"
                                     for v in beta_checks.values()),
          pt_walkers=cfg_a.num_chains, pt_replicas=cfg_a.pt_replicas,
          pt_rounds=rounds, pt_launches=f"{launches[0]},{launches[1]}",
          pt_parts_launches=f"{part[0]},{part[1]}+{resumed[0]},{resumed[1]}",
          resume="bit-equal",
          pt_delta_f=f"{df:.4f}+-{sem:.4f}",
          pt_delta_f_jax_r5=PT_JAX["delta_f"],
          df_particle_mbar=(f"{ra['df_particle_mbar']:.4f}+-"
                            f"{ra['df_particle_mbar_sem']:.4f}"),
          df_particle_mbar_jax_r5=PT_JAX["df_particle_mbar"],
          df_particle_cold=f"{ra['df_particle_cold']:.4f}",
          df_sector_cold=f"{ra['df_sector_cold']:.4f}",
          df_sector_mbar=f"{ra['df_sector_mbar']:.4f}",
          edge_acceptance=",".join(f"{a:.3f}" for a in ra["edge_acceptance"]),
          energy_drift=",".join(f"{d:.3g}" for d in drift),
          pt_wall_s=f"{wall_a:.2f}",
          pt_segments_ms_per_round=(
              f"{1e3 * sum(ra['segment_s']) / rounds:.4f}"),
          ms_per_round=f"{timing['ms_per_round']:.4f}",
          kernels_per_round=timing["kernels_per_round"],
          device_ms_per_round=(None if timing["device_ms_per_round"] is None
                               else f"{timing['device_ms_per_round']:.4f}"),
          idle_share=(None if timing["idle_share"] is None
                      else f"{timing['idle_share']:.3f}"),
          n1_delta_f_mala=f"{n1['mala']:.4f}",
          n1_delta_f_hmc=f"{n1['hmc']:.4f}", n1_exact=f"{exact:.4f}",
          grad_fd_rel_err=f"{grad_err:.3g}",
          budget_steps=sampler_steps,
          **{f"{k}_{f}": (f"{v[f]:.4f}" if isinstance(v[f], float)
                          else f"{v[f][0]},{v[f][1]}" if f == "launches"
                          else v[f])
             for k, v in drivers.items() for f in v},
          mala_ms_per_move=f"{mala_ms:.3f}",
          hmc_ms_per_trajectory=f"{hmc_ms:.3f}",
          npz_loss=f"{tn['final_loss']:.4f}", npz_samples=tn["num_samples"],
          npz_wall_s=f"{wall_npz:.2f}")
    return {"launches_pt": launches,
            "launches_mala_hmc": {k: v["launches"][1]
                                  for k, v in drivers.items()},
            "timing": timing, "max_abs_err": err_a}


# Phase 17: the other conditioner nets at the widths tools/n_mitigation.py
# ran them at N=8 (:146-157; RESULTS.md:203-221): N=8 at rho=0.03 with the
# reference's wells, K=15, 32 bins, num_blocks=2; the transformer at
# hidden (its embedding) 256 with 4 heads, the gnn at hidden 64
NETS = {"transformer": 256, "gnn": 64}
NETS_N = 8
NETS_FLOW = dict(K=15, num_bins=32, num_blocks=2)
# Algorithm 1 at N=8 with each net, cut as phase 13 cuts it (2 epochs, 100
# rounds of 150 moves, 64 chains) and to 160 samples a chain
NETS_A1 = dict(A1_SMOKE, num_particles=NETS_N, K=15, num_bins=32,
               initial_training_num_samples=64 * 160)
# float32 log q on the card against the same flow in float64 on the card,
# of (1 + |log q|): phase 12's bound for 6 dims and the residual net,
# times ten for 16 dims and the nets' longer float32 chains (softmax,
# messages summed over nodes)
NETS_FLOW_RTOL = 1e-3
# the paired pass against the separate ones in float32 over 15 layers:
# the batched products round apart from the single ones (the box is 16.3
# wide: an ulp is 1.9e-6)
NETS_POS_ATOL = 1e-3


def flow_step_timing(flow, data, reps: int = 5) -> dict:
    """One training step of ``flow`` on ``data`` (a batch): median ms by
    CUDA events, device kernels and device ms by the profiler, the peak
    memory of a step and its rise over what was allocated before it."""
    import torch

    from flowstate_tpu_torch.training import (
        TrainConfig, make_optimizer, make_train_step,
    )

    cfg = TrainConfig(batch_size=len(data))
    opt = make_optimizer(cfg)
    step = make_train_step(flow, cfg, opt)
    opt_state = [opt.init(list(flow.parameters()))]

    def train_step():
        opt_state[0], loss = step(opt_state[0], data)
        return loss

    require(bool(torch.isfinite(train_step())), "training step: loss")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"ms": median_ms(train_step, reps), **per_call(train_step, 1),
            "peak_mib": peak / 2 ** 20,
            "peak_over_base_mib": (peak - base) / 2 ** 20}


def phase_nets(card: str, chains: int = 16384, batch: int = 512,
               a1: dict = None) -> dict:
    """The transformer and the gnn at full width, N=8.  For each net: (a)
    on a perturbed tree, float32 log q against the same flow in float64
    on the card, forward then inverse back to the input, the paired pass
    against the separate passes; ms, device kernels and device ms of
    ``log_prob`` and of one big-move round at ``chains`` (its energies
    through K2), and of a training step at ``batch`` with its peak memory;
    (b) ``algorithm1.run`` at N=8 with that net: K1 and K2 launches
    against the schedule, a finite loss, acceptance in [0, 1].  (c) Once,
    the residual flow at A1's widths (N=3): a training step in bf16
    against float32, the bf16 flow's fused log q against its
    ``log_prob`` within 5e-3, and the unstacked flow (``scan_layers=
    False``) against the stacked one."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import algorithm1
    from flowstate_tpu_torch.flows import build_circular_flow, params_from_jax
    from flowstate_tpu_torch.mcmc import (
        init_alternating_wells, init_chain_state, nf_big_moves,
    )
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.utils.config import algorithm1_config

    # float32 products in full float32, as the residual flow's (phase 12)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on")
    spec = reference_spec(NETS_N)
    hb = spec.box.size_x / 2.0
    dim = 2 * NETS_N
    g = torch.Generator(device=DEVICE)
    g.manual_seed(31)
    x = torch.rand((chains, dim), generator=g, device=DEVICE) * (2 * hb) - hb
    pos, _ = init_alternating_wells(chains, NETS_N, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 7,
                             0.65)
    x_old = (state.positions - hb).reshape(chains, dim)
    out = {}
    for net_type, hidden in NETS.items():
        kw = dict(NETS_FLOW, hidden_units=hidden, net_type=net_type)
        flow = build_circular_flow(NETS_N, 2, hb, generator=g, device=DEVICE,
                                   **kw)
        tree = perturbed_tree(flow, 32)
        params_from_jax(tree, flow)
        ref = build_circular_flow(NETS_N, 2, hb, device=DEVICE,
                                  dtype=torch.float64, **kw)
        params_from_jax(tree, ref)
        with torch.no_grad():
            lp = flow.log_prob(x)
            lp64 = ref.log_prob(x.double())
            back = flow.inverse(flow.forward(x))
            g2 = torch.Generator(device=DEVICE)
            g2.manual_seed(33)
            paired = flow.sample_and_log_prob_with_old(chains, x_old, g2)
            g2.manual_seed(33)
            new, lq_new = flow.sample_and_log_prob(chains, g2)
            lq_old = flow.log_prob(x_old)
        del ref
        d = (lp.double() - lp64).abs()
        lp_rel = float((d / (1.0 + lp64.abs())).max())
        trip_err = float((back - x).abs().max())
        pos_err = float((paired[0] - new).abs().max())
        lq_err = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                     for a, b in ((paired[1], lq_new), (paired[2], lq_old)))
        require(bool(torch.isfinite(lp).all()) and lp_rel <= NETS_FLOW_RTOL,
                f"{net_type}: log q vs float64 {lp_rel} relative")
        require(math.isfinite(trip_err) and trip_err <= 0.01 * hb,
                f"{net_type}: round trip error {trip_err}")
        require(pos_err <= NETS_POS_ATOL and lq_err <= NETS_FLOW_RTOL,
                f"{net_type}: paired vs separate: positions {pos_err}, "
                f"log q {lq_err} relative")

        def log_prob():
            return flow.log_prob(x)

        def big_move():
            return nf_big_moves(spec, 1.0, state, flow, hb, g)

        times = {}
        with torch.no_grad():
            for name, fn in (("log_prob", log_prob),
                             ("big_move_round", big_move)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                cp.LAUNCHES = 0
                fn()
                torch.cuda.synchronize()
                launches_k2 = cp.LAUNCHES
                times[name] = {"ms": median_ms(fn, 5), **per_call(fn, 1),
                               "peak_mib": torch.cuda.max_memory_allocated()
                               / 2 ** 20, "k2_launches": launches_k2}
        require(times["big_move_round"]["k2_launches"] == 1
                and times["log_prob"]["k2_launches"] == 0,
                f"{net_type}: K2 launches per big-move round "
                f"{times['big_move_round']['k2_launches']}")
        times["train_step"] = flow_step_timing(flow, x[:batch].clone())
        del flow
        torch.cuda.empty_cache()

        # (b) Algorithm 1 at N=8 with this net ------------------------
        with tempfile.TemporaryDirectory(dir=REPO,
                                         prefix=".chip_smoke_") as tmp:
            config = algorithm1_config(
                experiment_id=f"chip_smoke_{net_type}", output_dir=tmp,
                hidden_units=hidden, net_type=net_type,
                **(a1 or NETS_A1))
            expected = a1_schedule(config)
            cm.LAUNCHES = cp.LAUNCHES = 0
            t0 = time.perf_counter()
            result = algorithm1.run(config, device=DEVICE)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = (cm.LAUNCHES, cp.LAUNCHES)
        loss, acc = result["final_loss"], result["big_move_acceptance"]
        require(launches == expected,
                f"A1 with {net_type} launched K1, K2 {launches} times, "
                f"schedule implies {expected}")
        require(loss is not None and np.isfinite(loss),
                f"A1 with {net_type}: final loss {loss}")
        require(0.0 <= acc <= 1.0, f"A1 with {net_type}: acceptance {acc}")
        out[net_type] = {**times, "log_q_rel": lp_rel, "trip_err": trip_err,
                         "paired_pos_err": pos_err, "paired_lq_rel": lq_err,
                         "a1": {"launches": launches, "final_loss": loss,
                                "acceptance": acc, "wall_s": wall_s,
                                "phase_s": result["phase_s"]}}
        for name in ("log_prob", "big_move_round", "train_step"):
            v = times[name]
            print(f"  {net_type} {name}: " + " ".join(
                f"{k}={v[k]:.4f}" if isinstance(v[k], float)
                else f"{k}={v[k]}" for k in v), flush=True)
        phase(f"17 {net_type}", card=f"'{card}'", n=NETS_N, hidden=hidden,
              chains=chains, batch=batch, log_q_vs_float64_rel=f"{lp_rel:.3g}",
              round_trip_err=f"{trip_err:.3g}",
              paired_pos_err=f"{pos_err:.3g}", paired_log_q_rel=f"{lq_err:.3g}",
              log_prob_ms=f"{times['log_prob']['ms']:.3f}",
              big_move_ms=f"{times['big_move_round']['ms']:.3f}",
              train_step_ms=f"{times['train_step']['ms']:.3f}",
              train_step_peak_mib=f"{times['train_step']['peak_mib']:.1f}",
              a1_launches_k1=launches[0], a1_expected_k1=expected[0],
              a1_launches_k2=launches[1], a1_expected_k2=expected[1],
              a1_final_loss=f"{loss:.4f}", a1_acceptance=f"{acc:.4f}",
              **{f"a1_phase_{k}_s": f"{v:.2f}"
                 for k, v in result["phase_s"].items()},
              a1_wall_s=f"{wall_s:.2f}")

    # (c) the residual flow's options at A1's widths (N=3) -------------
    spec3 = reference_spec(3)
    hb3 = spec3.box.size_x / 2.0
    x3 = (torch.rand((chains, 6), generator=g, device=DEVICE) * (2 * hb3)
          - hb3)
    flows = {}
    for label, kw in (("float32", {}),
                      ("bfloat16", dict(compute_dtype="bfloat16")),
                      ("unstacked", dict(scan_layers=False))):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(34)
        flows[label] = build_circular_flow(3, 2, hb3, generator=gen,
                                           device=DEVICE, **A1_FLOW, **kw)
    def fused_vs_log_prob(flow):
        """|log q of a sample from the fused forward pass - log_prob of
        it|: its largest value and its 99th percentile over ``chains``."""
        g3 = torch.Generator(device=DEVICE)
        g3.manual_seed(36)
        with torch.no_grad():
            xs, lq_fused = flow.sample_and_log_prob(chains, g3)
            d = (lq_fused - flow.log_prob(xs)).abs()
        return float(d.max()), float(torch.quantile(d, 0.99))

    # the bf16 flow's MH consistency as tests/test_bf16.py holds JAX's: at
    # the flow's own init, within 5e-3
    init_err, _ = fused_vs_log_prob(flows["bfloat16"])
    require(init_err <= 5e-3,
            f"bf16 at init: fused log q vs log_prob differ by {init_err}")
    tree = perturbed_tree(flows["float32"], 35)
    for label in ("float32", "bfloat16"):
        params_from_jax(tree, flows[label])
    params_from_jax(tuple(layer_slices(tree[0], A1_FLOW["K"])),
                    flows["unstacked"])
    with torch.no_grad():
        lp32 = flows["float32"].log_prob(x3)
        lp_unstacked = flows["unstacked"].log_prob(x3)
    unstacked_err = float((lp_unstacked - lp32).abs().max())
    require(unstacked_err <= FLOW_RTOL * (1.0 + float(lp32.abs().max())),
            f"unstacked vs stacked log q differ by {unstacked_err}")
    # on perturbed weights each layer's round trip moves the next layer's
    # net input, and bf16 rounds that move up: JAX's bf16 flow parts by
    # up to 0.00998 at such weights, 8.2e-4 at the 99th percentile, over
    # 4,096 points on a CPU (tests/test_torch_nets.py::test_bf16_fused_
    # log_q_parts_from_log_prob_off_the_init_in_both), so the percentile
    # is held to 5e-3 and the largest printed
    fused = {label: fused_vs_log_prob(flows[label])
             for label in ("float32", "bfloat16")}
    require(fused["bfloat16"][1] <= 5e-3,
            f"bf16: fused log q vs log_prob, 99th percentile "
            f"{fused['bfloat16'][1]}")
    steps = {label: flow_step_timing(flows[label], x3[:batch].clone())
             for label in ("float32", "bfloat16")}
    for label, v in steps.items():
        print(f"  residual N=3 train_step {label}: " + " ".join(
            f"{k}={v[k]:.4f}" if isinstance(v[k], float) else f"{k}={v[k]}"
            for k in v), flush=True)
    phase("17 residual options", card=f"'{card}'", n=3, batch=batch,
          bf16_init_fused_log_q_err=f"{init_err:.3g}",
          **{f"{k}_fused_log_q_max": f"{v[0]:.3g}" for k, v in fused.items()},
          **{f"{k}_fused_log_q_p99": f"{v[1]:.3g}" for k, v in fused.items()},
          unstacked_log_q_max_diff=f"{unstacked_err:.3g}",
          **{f"train_step_{k}_ms": f"{v['ms']:.3f}" for k, v in steps.items()},
          **{f"train_step_{k}_device_ms": (
              "not_measured" if v["device_ms"] is None
              else f"{v['device_ms']:.3f}") for k, v in steps.items()},
          **{f"train_step_{k}_peak_mib": f"{v['peak_mib']:.1f}"
             for k, v in steps.items()})
    out["residual_options"] = {"steps": steps, "fused": fused,
                               "init_err": init_err,
                               "unstacked_err": unstacked_err}
    return out


# Phase 18: the multi-device layer (parallel/, the replica-sharded swap,
# entry.py).  K1's shards against the whole launch at (N, chains, moves,
# a beta per chain): the reference preset's N=3 at the timing width, N=1024
# at the single run's 128 chains, N=8 at PT's 2,560 chains
MULTI_K1 = ((3, 16384, 1000, False), (1024, 128, 200, False),
            (8, 2560, 200, True))
MULTI_SWAP = (10, 256)      # replicas x walkers, TEMPERING.md's width


def k1_in_shards(spec, beta, state, moves: int, parts: int) -> dict:
    """K1 launched once per rank's shard of ``state`` (``shard_chain_state``
    at ranks 0..parts-1 of a mesh of ``parts``, each at its chain offset),
    the shards' outputs joined in rank order."""
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.parallel import ChainMesh, shard_chain_state

    outs = []
    for rank in range(parts):
        mesh = ChainMesh(rank, parts, state.device)
        shard = shard_chain_state(state, mesh)
        b = beta
        if isinstance(beta, torch.Tensor):
            rows = shard.chain_offset - state.chain_offset
            b = beta[rows:rows + shard.positions.shape[0]].contiguous()
        outs.append(cm.run_moves_kernel(spec, b, shard, moves))
    return {f: torch.cat([getattr(o, f) for o in outs])
            for f in ("positions", "energy", "accepts", "attempts")}


def phase_multi_device(card: str, k1_shapes=MULTI_K1, swap=MULTI_SWAP,
                       reps: int = 10) -> dict:
    """The multi-device layer on the one card.

    (a) K1 over halves and quarters of the chains, each launch at its
    shard's ``chain_offset``, against one launch over all of them:
    positions, energy, accepts and attempts bit-equal, at each of
    ``MULTI_K1``; and halves of the N=3 batch whose ``chain_offset + c``
    crosses 2^31 (the key's add is unsigned 32-bit).  (b)
    ``entry.dryrun_multichip(1)``: the eight steps at world size 1 over
    NCCL on cuda:0, each rank's K1 and K2 launches, and the ring's path.
    (c) At A1's widths (``entry.entry``: K=15, hidden 256, 32 bins, batch
    512, weights perturbed), one data-parallel step at world size 1
    against ``make_train_step``: loss and parameters bit-equal (and two
    single steps against each other, printed).  (d)
    CUDA-event times: the DP step and the single step, the NCCL
    all-reduce of the step's flat gradient buffer, the replica-sharded
    swap at 10 x 256 against ``swap_replicas`` (and bit-equal to it on
    the same uniforms).  The times are readings, not claims."""
    import copy

    import torch
    import torch.distributed as dist

    from flowstate_tpu_torch import entry as entry_mod
    from flowstate_tpu_torch.flows import params_from_jax
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import (
        init_alternating_wells, init_chain_state, init_tempered_state,
        swap_replicas, swap_replicas_replica_sharded, temperature_ladder,
    )
    from flowstate_tpu_torch.ops import SystemSpec
    from flowstate_tpu_torch.parallel import (
        initialize_distributed, make_data_parallel_train_step,
    )
    from flowstate_tpu_torch.parallel.launch import free_tcp_address
    from flowstate_tpu_torch.training import (
        TrainConfig, make_optimizer, make_train_step,
    )

    # (a) K1's shards against the whole launch ------------------------------
    checked = []
    for n, chains, moves, per_chain in k1_shapes:
        if n <= 12:     # the wells' start of the experiments
            spec = reference_spec(n)
            pos, _ = init_alternating_wells(chains, n, 0.03)
            pos = torch.as_tensor(pos, device=DEVICE)
        else:           # phase 3's lattice at the single run's density
            pos, box = jittered_lattices(n, chains, n + chains)
            spec = SystemSpec.create(n, box, num_wells=0,
                                     V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
        state = init_chain_state(spec, pos, 41, 0.65)
        beta = 1.0
        if per_chain:
            beta = temperature_ladder(1.0, 10.0, 10, device=DEVICE)
            beta = beta.repeat_interleave(chains // 10).contiguous()
        out = cm.run_moves_kernel(spec, beta, state, moves)
        whole = {f: getattr(out, f)
                 for f in ("positions", "energy", "accepts", "attempts")}
        for parts in (2, 4):
            got = k1_in_shards(spec, beta, state, moves, parts)
            for f, v in whole.items():
                require(torch.equal(got[f], v),
                        f"K1 in {parts} shards at N={n}, {chains} chains: "
                        f"{f} differs from the whole launch")
        checked.append(f"N={n}:{chains}x{moves}"
                       + (":beta_per_chain" if per_chain else ""))
        if len(checked) == 1:
            first = (spec, state, out, chains, moves)
    # across 2^31, at the first shape: the whole batch at offset 2^31 -
    # C/2, its halves at 2^31 - C/2 and 2^31; and the offset moves the
    # streams
    spec, state, at_zero, chains, moves = first
    high = state.replace(chain_offset=2 ** 31 - chains // 2,
                         total_chains=2 ** 31 + chains // 2)
    whole_high = cm.run_moves_kernel(spec, 1.0, high, moves)
    halves = k1_in_shards(spec, 1.0, high, moves, 2)
    for f in halves:
        require(torch.equal(halves[f], getattr(whole_high, f)),
                f"K1 halves across 2^31: {f} differs from the whole launch")
    require(not torch.equal(whole_high.positions, at_zero.positions),
            "K1 at chain offset 2^31 - C/2 moved as at offset 0")
    checked.append(f"N={spec.num_particles}:halves_across_2^31")
    torch.cuda.synchronize()

    # (b) the dry run at world size 1 over NCCL ------------------------------
    t0 = time.perf_counter()
    dry, = entry_mod.dryrun_multichip(1, DEVICE, timeout=600)
    dry_s = time.perf_counter() - t0
    require(dry["backend"] == "nccl" and dry["k1_launches"] > 0
            and dry["k2_launches"] > 0,
            f"the dry run's summary {dry}")

    # (c), (d) in this process, world size 1 over NCCL -----------------------
    mesh = initialize_distributed(free_tcp_address(), 1, 0, DEVICE)
    try:
        fn, (model, batch) = entry_mod.entry(DEVICE)
        params_from_jax(perturbed_tree(model, 18), model)
        config = TrainConfig(batch_size=batch.shape[0], lr=1e-4)
        opt = make_optimizer(config)
        models = [copy.deepcopy(model) for _ in range(3)]
        steps = [make_train_step(models[0], config, opt),
                 make_train_step(models[1], config, opt),
                 make_data_parallel_train_step(models[2], config, opt, mesh)]
        losses = [step(opt.init(list(m.parameters())), batch)[1]
                  for step, m in zip(steps, models)]
        torch.cuda.synchronize()

        @torch.no_grad()
        def diff(a, b):
            return max([float((a[1] - b[1]).abs())]
                       + [float((p - q).abs().max()) for p, q in
                          zip(a[0].parameters(), b[0].parameters())])

        runs = list(zip(models, losses))
        repeat_diff, dp_diff = diff(runs[0], runs[1]), diff(runs[0], runs[2])
        require(torch.isfinite(losses[2]) and dp_diff == 0.0,
                f"the DP step at world size 1 parts from the single step by "
                f"{dp_diff} (two single steps by {repeat_diff})")

        # in turns (single, DP, DP, single): the host sets both steps'
        # times and its speed drifts
        state0 = opt.init(list(models[2].parameters()))
        turns = [cuda_ms(lambda i=i: steps[i](state0, batch), reps)
                 for i in (0, 2, 2, 0)]
        single_ms, dp_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        # the step's buffer: every gradient and the loss
        flat = torch.cat([p.detach().reshape(-1)
                          for p in models[2].parameters()] + [losses[2][None]])
        allreduce_us = 1e3 * cuda_ms(lambda: dist.all_reduce(flat), 100)

        r, w = swap
        spec = reference_spec(3)
        pos, _ = init_alternating_wells(w, 3, 0.03)
        pt = init_tempered_state(spec, torch.as_tensor(
            pos, device=DEVICE)[None].repeat(r, 1, 1, 1), 43, 0.65)
        pt = pt.replace(energy=pt.energy + torch.randn(
            r * w, generator=torch.Generator(device=DEVICE).manual_seed(44),
            device=DEVICE))
        betas = temperature_ladder(1.0, 10.0, r, device=DEVICE)
        u = torch.rand((r, w), generator=torch.Generator(
            device=DEVICE).manual_seed(45), device=DEVICE)
        for parity in (0, 1):
            a = swap_replicas(betas, pt, None, parity, u=u)
            b = swap_replicas_replica_sharded(betas, pt, None, parity, mesh,
                                              u=u)
            require(torch.equal(a.accepted, b.accepted)
                    and all(torch.equal(getattr(a.state, f),
                                        getattr(b.state, f))
                            for f in ("positions", "energy")),
                    f"replica-sharded swap at world size 1, parity {parity}")
        g = torch.Generator(device=DEVICE).manual_seed(46)
        swap_ms = cuda_ms(lambda: swap_replicas_replica_sharded(
            betas, pt, g, 0, mesh), 50)
        plain_swap_ms = cuda_ms(lambda: swap_replicas(betas, pt, g, 0), 50)
        ring = mesh.ring_path
    finally:
        dist.destroy_process_group()

    phase("18 multi-device", card=f"'{card}'",
          k1_shards_bit_equal=",".join(checked),
          dryrun_backend=dry["backend"], dryrun_ring=dry["ring_path"],
          dryrun_k1_launches=dry["k1_launches"],
          dryrun_k2_launches=dry["k2_launches"],
          dryrun_accepts=dry["accepts"], dryrun_swaps=dry["swaps"],
          dryrun_s=f"{dry_s:.1f}",
          dp_loss=f"{float(losses[2]):.6g}", dp_vs_single=dp_diff,
          single_vs_single=repeat_diff,
          dp_step_ms=f"{dp_ms:.3f}", single_step_ms=f"{single_ms:.3f}",
          step_turns_ms=",".join(f"{t:.3f}" for t in turns),
          allreduce_us=f"{allreduce_us:.2f}",
          allreduce_bytes=flat.numel() * flat.element_size(),
          swap_ring=ring, swap_shape=f"{r}x{w}",
          sharded_swap_ms=f"{swap_ms:.4f}", swap_ms=f"{plain_swap_ms:.4f}")
    return {"launches": (dry["k1_launches"], dry["k2_launches"])}


# Phase 19: the dense flow zoo.  (a) the circular autoregressive spline as
# A1's big-move proposal at A1's widths (utils/config.py: K 15, hidden 256,
# 32 bins; MADE's 2 blocks, tail bound L/2); (b) the normflows README's
# RealNVP and (c) neural-spline examples as the JAX classes express them,
# on TwoMoons; (d) HAIS on tests/test_flow_zoo.py's target
ZOO_A = dict(K=15, hidden=256, bins=32, blocks=2)
ZOO_SAMPLE_BLOCKS = 100       # K1 launches of 150 moves at 100 chains
ZOO_EPOCHS = 3                # of training.train at batch 512 on them
ZOO_LR = 1e-3
ZOO_ROUNDS = {100: 10, 16384: 3}   # big-move rounds at each chain count
ZOO_LOG_Q_RTOL = 1e-3         # log_prob of a sample vs its fused log q
# Adam steps of (b) and (c) at batch 512, cut from a few hundred so that
# phase 19 stays within 60 s (200 each took 32 s of its 67)
ZOO_TOY_STEPS = 100
# (b) and (c): forward then inverse of 4,096 base points.  In float32
# the errors grow with |x| through the layers, and the worst points (in
# the Gaussian's tails) read 1.55e-4 for (b) and 6.8e-4 for (c) on the
# card (3.2e-4 for (c) on a CPU, 1.8e-5 at its 99th percentile), so the
# 99th percentile is held within ZOO_TRIP_ATOL and the largest printed;
# the same flow cast to float64 within ZOO_TRIP_F64 at every point
ZOO_TRIP_QUANTILE = 0.99
ZOO_TRIP_ATOL = 1e-4
ZOO_TRIP_F64 = 1e-10
ZOO_HAIS = dict(samples=4096, tol=0.25)   # test_flow_zoo.py's bound


def zoo_toy_flow(card: str, label: str, flow, steps: int, lr: float,
                 weight_decay: float = 0.0) -> dict:
    """The normflows README's loop on TwoMoons at batch 512: torch's Adam,
    ``forward_kld`` with the base term, a step only on a finite loss.
    The loss falls (the last 20 steps' mean below the first 20's) and
    forward then inverse returns its input: the ``ZOO_TRIP_QUANTILE`` of
    the float32 errors within ``ZOO_TRIP_ATOL``, every float64 error (the
    same flow cast) within ``ZOO_TRIP_F64``."""
    import copy

    import torch

    from flowstate_tpu_torch.flows import TwoMoons

    target = TwoMoons()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(71)
    opt = torch.optim.Adam(flow.parameters(), lr=lr,
                           weight_decay=weight_decay)
    losses = []

    def step():
        x = target.sample(512, g, DEVICE)
        loss = flow.forward_kld(x, include_base=True)
        if torch.isfinite(loss):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        losses.append(loss.detach())

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    timing = per_call(step, 1)
    losses = torch.stack(losses).cpu()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    require(bool(torch.isfinite(losses).all()) and last < first,
            f"{label}: loss {first} -> {last} over {steps} steps")
    with torch.no_grad():
        z = flow.base.sample(4096, g, DEVICE)
        err = (flow.inverse(flow.forward(z)) - z).abs().flatten()
        flow64 = copy.deepcopy(flow).double()
        z64 = z.double()
        trip64 = float((flow64.inverse(flow64.forward(z64)) - z64).abs()
                       .max())
    trip = float(err.max())
    trip_q = float(torch.quantile(err, ZOO_TRIP_QUANTILE))
    require(trip_q <= ZOO_TRIP_ATOL and trip64 <= ZOO_TRIP_F64,
            f"{label}: round trip error {trip_q} at the quantile "
            f"{ZOO_TRIP_QUANTILE} (largest {trip}), {trip64} in float64")
    out = {"ms": ms, **timing, "loss_first": first, "loss_last": last,
           "trip_err": trip, "trip_err_q": trip_q, "trip_err_f64": trip64}
    phase(f"19{label[0]} {label[2:]}", card=f"'{card}'", steps=steps,
          batch=512, step_ms=f"{ms:.3f}", step_kernels=timing["kernels"],
          step_device_ms=("not_measured" if timing["device_ms"] is None
                          else f"{timing['device_ms']:.3f}"),
          loss_first20=f"{first:.4f}", loss_last20=f"{last:.4f}",
          round_trip_err=f"{trip:.3g}",
          round_trip_err_q99=f"{trip_q:.3g}",
          round_trip_err_float64=f"{trip64:.3g}")
    return out


def phase_zoo(card: str, rounds: dict = None, sample_blocks: int =
              ZOO_SAMPLE_BLOCKS, epochs: int = ZOO_EPOCHS,
              toy_steps: int = ZOO_TOY_STEPS, a_widths: dict = None,
              hais_samples: int = ZOO_HAIS["samples"]) -> dict:
    """The dense flow zoo on the card.  (a) K=15 circular autoregressive
    spline layers over ``UniformParticle(3, 2, L/2)``, every coordinate
    circular, at A1's widths: samples from K1 at 100 chains, ``training.
    train`` at batch 512, then ``nf_big_moves`` rounds at 100 and 16,384
    chains, K2 pricing the proposals; K1's and K2's launches by their
    wrappers' counts and by the profiler (at least one record each, F6),
    the acceptance in (0, 1], every ratio finite or -inf (an overlapping
    proposal), ``log_prob`` of the proposals against their fused log q;
    ms, kernels and device ms a round.  (b) and (c) the normflows
    examples, (d) HAIS's log Z."""
    import numpy as np
    import torch

    from flowstate_tpu_torch import flows as F
    from flowstate_tpu_torch.mcmc import (
        init_alternating_wells, init_chain_state, nf_big_moves,
        run_moves_auto, to_centered,
    )
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.state import batched_energy_virial
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.training import TrainConfig, train

    rounds = rounds or ZOO_ROUNDS
    w = a_widths or ZOO_A
    spec = reference_spec(3)
    hb = spec.box.size_x / 2.0
    t_phase = time.perf_counter()

    def gen(seed):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        return g

    # (a) the slice's path ------------------------------------------
    g = gen(61)
    layer = F.CircularAutoregressiveRationalQuadraticSpline(
        6, w["blocks"], w["hidden"], ind_circ=tuple(range(6)),
        num_bins=w["bins"], tail_bound=hb)
    flow = F.NormalizingFlow(
        F.UniformParticle(3, 2, hb),
        [F.ParamLayer(layer, g, device=DEVICE) for _ in range(w["K"])],
        device=DEVICE)
    cm.LAUNCHES = cp.LAUNCHES = 0
    pos, _ = init_alternating_wells(100, 3, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 62,
                             0.65)
    state = run_moves_auto(spec, 1.0, state, 5000)
    samples = []
    for _ in range(sample_blocks):
        state = run_moves_auto(spec, 1.0, state, 150)
        samples.append(to_centered(state.positions, hb))
    data = torch.cat(samples)
    t0 = time.perf_counter()
    _, _, history, loss_epoch = train(
        flow, data, TrainConfig(batch_size=512, epochs=epochs, lr=ZOO_LR),
        gen(63))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    require(all(math.isfinite(v) for v in loss_epoch),
            f"zoo (a): epoch losses {loss_epoch}")
    big_c = max(rounds)
    pos_big, _ = init_alternating_wells(big_c, 3, 0.03)
    big = init_chain_state(spec, torch.as_tensor(pos_big, device=DEVICE),
                           64, 0.65)
    big = run_moves_auto(spec, 1.0, big, 1000)
    states = {100: state, big_c: big}
    accepted = attempted = 0
    ratios_ok = True
    with torch.no_grad():
        for c, n in rounds.items():
            s = states[c]
            for _ in range(n):
                res = nf_big_moves(spec, 1.0, s, flow, hb, g)
                s = res.state
                accepted += int(res.accepted.sum())
                attempted += c
                r = res.ratio_log
                ratios_ok &= bool((torch.isfinite(r) | torch.isneginf(r))
                                  .all())
            states[c] = s
    torch.cuda.synchronize()
    launches = (cm.LAUNCHES, cp.LAUNCHES)
    expected_k2 = 2 + sum(rounds.values())   # the two states' energies
    require(launches == (sample_blocks + 2, expected_k2),
            f"zoo (a): K1, K2 launched {launches} times, the path implies "
            f"{(sample_blocks + 2, expected_k2)}")
    acceptance = accepted / attempted
    require(0.0 < acceptance <= 1.0, f"zoo (a): acceptance {acceptance}")
    require(ratios_ok, "zoo (a): a NaN or +inf MH log-ratio")

    with torch.no_grad():
        xs, lq = flow.sample_and_log_prob(16384, g)
        lp = flow.log_prob(xs)
    d = (lp - lq).abs()
    lq_rel = float((d / (1.0 + lq.abs())).max())
    require(bool(torch.isfinite(lq).all()) and lq_rel <= ZOO_LOG_Q_RTOL,
            f"zoo (a): log_prob vs fused log q {lq_rel} relative")

    # the profiler sees K1 and K2.  It loses records, the more the longer
    # the process has run (F6: of 20 K1 calls in a window, 20 before
    # phase 16, 10 or 20 after it, 4 after phase 17, 3 or 20 after phase
    # 18, none in two windows of one run), so up to five windows of 20
    # calls of each at the path's shapes, until both are recorded
    def k1_and_k2():
        run_moves_auto(spec, 1.0, states[100], 150)
        batched_energy_virial(spec, states[big_c].positions)

    seen = {"metropolis_moves_kernel": 0, "pair_": 0}
    for _ in range(5):
        for e in device_kernels(k1_and_k2, 20):
            for name in seen:
                seen[name] += name in e.name
        if all(seen.values()):
            break
    k1_seen, k2_seen = seen.values()
    require(k1_seen >= 1 and k2_seen >= 1,
            f"zoo (a): in five profiled windows K1 was recorded {k1_seen} "
            f"and K2 {k2_seen} times")

    per_round = {}
    with torch.no_grad():
        for c in rounds:
            def round_fn(c=c):
                return nf_big_moves(spec, 1.0, states[c], flow, hb, g)

            per_round[c] = {"ms": median_ms(round_fn, 3),
                            **per_call(round_fn, 1)}
    for c, v in per_round.items():
        print(f"  zoo (a) big-move round at {c} chains: " + " ".join(
            f"{k}={v[k]:.4f}" if isinstance(v[k], float) else f"{k}={v[k]}"
            for k in v), flush=True)
    steps = len(history)
    phase("19a zoo circular autoregressive", card=f"'{card}'", K=w["K"],
          hidden=w["hidden"], bins=w["bins"], samples=len(data),
          train_steps=steps, train_ms_per_step=f"{train_s / steps * 1e3:.3f}",
          final_epoch_loss=f"{loss_epoch[-1]:.4f}",
          k1_launches=launches[0], k2_launches=launches[1],
          profiler_k1=k1_seen, profiler_k2=k2_seen,
          acceptance=f"{acceptance:.5f}", attempts=attempted,
          log_q_rel=f"{lq_rel:.3g}",
          **{f"round_{c}_ms": f"{v['ms']:.3f}" for c, v in per_round.items()},
          **{f"round_{c}_kernels": v["kernels"]
             for c, v in per_round.items()},
          **{f"round_{c}_device_ms": ("not_measured" if v["device_ms"] is None
                                      else f"{v['device_ms']:.3f}")
             for c, v in per_round.items()})
    del flow, states, big, state
    torch.cuda.empty_cache()

    # (b) RealNVP, (c) the neural-spline flow, on TwoMoons -------------
    g = gen(65)
    realnvp = F.NormalizingFlow(F.DiagGaussian(2), [
        F.ParamLayer(l, g, device=DEVICE) for _ in range(32)
        for l in (F.AffineCouplingBlock(F.MLP((1, 64, 64, 2),
                                              init_zeros=True)),
                  F.Permute(2, "swap"))], device=DEVICE)
    b = zoo_toy_flow(card, "b realnvp", realnvp, toy_steps, 5e-4, 1e-5)
    nsf = F.NormalizingFlow(F.DiagGaussian(2, trainable=False), [
        F.ParamLayer(l, g, device=DEVICE) for _ in range(16)
        for l in (F.AutoregressiveRationalQuadraticSpline(2, 2, 128),
                  F.LULinearPermute(2))], device=DEVICE)
    c_ = zoo_toy_flow(card, "c neural spline", nsf, toy_steps, 5e-4)

    # (d) HAIS --------------------------------------------------------
    class Target:
        """Unnormalised N(0, 0.5^2 I) times C, log C = 1.7."""

        def log_prob(self, z):
            return -(z ** 2).sum(-1) / (2 * 0.25) + 1.7

    hais = F.HAIS(tuple(np.linspace(1.0, 0.0, 12)), F.DiagGaussian(2),
                  Target(), num_leapfrog=3, dim=2, step_size=0.2)
    g = gen(66)
    t0 = time.perf_counter()
    _, log_w = hais.sample(hais.init_params(g, device=DEVICE), hais_samples,
                           g, DEVICE)
    est = float(torch.logsumexp(log_w, 0) - math.log(hais_samples))
    hais_s = time.perf_counter() - t0
    exact = 1.7 + math.log(2 * math.pi * 0.25)
    require(abs(est - exact) < ZOO_HAIS["tol"],
            f"HAIS log Z {est}, exact {exact}")
    wall = time.perf_counter() - t_phase
    phase("19d hais", card=f"'{card}'", samples=hais_samples,
          log_z=f"{est:.4f}", exact=f"{exact:.4f}", ms=f"{hais_s * 1e3:.1f}",
          phase_19_s=f"{wall:.1f}")
    return {"launches": launches, "acceptance": acceptance,
            "rounds": per_round, "realnvp": b, "nsf": c_, "hais": est,
            "wall_s": wall}


# Phase 20: the image, residual and Lipschitz flows.  (a) normflows'
# examples/glow.ipynb at its widths: L = 3 levels of K = 16 GlowBlocks
# (hidden 256, affine with scale) and a Squeeze, GlowBase bases, channel
# merges, 3 x 32 x 32 images at batch 128, the port's Adam at 1e-4 and the
# example's weight decay 1e-5 (the example's 1e-3 follows its data-
# dependent ActNorm init, which neither package's MultiscaleFlow has, and
# from the zero init a step at 1e-3 can throw the loss up many-fold);
# (b) examples/residual.ipynb: K = 16 Residual(
# LipschitzMLP((2, 128, 128, 2), coeff 0.9)) each followed by ActNorm(2)
# over DiagGaussian(2), the series estimator, on TwoModes(2, 0.1) samples at
# batch 512, torch's Adam at 1e-3 and weight decay 1e-5 on the loss with the
# base term, each net's update_lipschitz after each step; (c) the
# induced-norm layers against closed forms, and an InducedNormCNN residual
# block on 12 x 16 x 16 images at batch 64
GLOW = dict(levels=3, K=16, hidden=256, channels=3, size=32, batch=128)
GLOW_STEPS = 12               # Adam steps; the loss over the last 3 < first 3
GLOW_LR = 1e-4
# log_prob of a batch in float32 against the same flow cast to float64, of
# (1 + |log q|): float32 rounding over 3,072 dimensions and 48 blocks
GLOW_F64_RTOL = 1e-4
# x -> latents -> x in float32, and the two log-dets' sum of (1 + |ld|)
GLOW_TRIP_ATOL = 1e-3
GLOW_TRIP_LD_RTOL = 1e-4
RESIDUAL = dict(K=16, hidden=128, coeff=0.9, batch=512)
RESIDUAL_STEPS = 20
RESIDUAL_LIP_ITERS = 50       # power-iteration steps a net after each step
# a normalised weight's spectral norm over coeff: u is the converged power
# vector only up to the last step's move of w
RESIDUAL_NORM_RTOL = 1e-3
RESIDUAL_TRIP_ATOL = 1e-4     # z -> fixed-point forward -> inverse, float32
# (c): sigma at most the closed form, at 2->2 equal to it, within 1e-3
# (tests/test_lipschitz.py's upper bound); sigma against the norm ratio its
# v attains, float32 rounding; the conv's within 1e-3 of its dense
# operator's norm
LIP_CLOSED = 1e-3
LIP_ATTAINED = 1e-4
LIP_CONV_RTOL = 1e-3
LIP_CNN = dict(channels=(12, 64, 64, 12), kernels=(3, 1, 3), size=16,
               batch=64, coeff=0.9)
LIP_CNN_SERIES_RTOL = 1e-4    # the estimator against the dense J's series
# a Residual layer's series log-det (float32) against the same truncated
# series, on the same probes, from its net's dense Jacobian in float64, of
# (1 + |log-det|) per sample
RESIDUAL_SERIES_RTOL = 1e-4
# nets.conv2d in float32 against native F.conv2d in float64 (the output,
# the first and the second derivatives of a loss), and the gradients of a
# series log-det loss (through the conv's double backward) and of a
# GlowBlock loss in float32 against the same in float64: max |diff| over
# max |float64| per tensor (``grad_error``).  Float32 reads some 1e-6;
# TF32 rounds the operands to 10 bits (2^-11 relative)
CONV_GRAD_RTOL = 1e-4


def glow_flow(g, levels, K, hidden, channels, size, **_):
    """normflows' Glow: level i has K ``GlowBlock(3 * 2^(L + 1 - i))`` and
    a ``Squeeze``, each level after the first joined by a channel
    ``Merge``; bases (48, 4, 4), (12, 8, 8), (6, 16, 16) at L = 3."""
    from flowstate_tpu_torch import flows as F

    flows, bases, merges = [], [], []
    for i in range(levels):
        c = channels * 2 ** (levels + 1 - i)
        flows.append([F.ParamLayer(F.GlowBlock(c, hidden), g, device=DEVICE)
                      for _ in range(K)]
                     + [F.ParamLayer(F.Squeeze(), device=DEVICE)])
        if i > 0:
            merges.append(F.Merge(mode="channel"))
            bases.append(F.GlowBase((channels * 2 ** (levels - i),
                                     size // 2 ** (levels - i),
                                     size // 2 ** (levels - i))))
        else:
            bases.append(F.GlowBase((c, size // 2 ** levels,
                                     size // 2 ** levels)))
    return F.MultiscaleFlow(bases, flows, merges, device=DEVICE)


# cuDNN's convolution kernels by name (forward, data and weight gradients)
CONV_KERNEL_PARTS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm",
                     "winograd", "cudnn")


def step_kernels(fn, label: str) -> dict:
    """By the profiler, over one call of ``fn``: its device kernels and
    device ms, the ms of the convolution kernels (``CONV_KERNEL_PARTS``),
    how many kernels name TF32, and the six costliest kernels (printed).
    None where the profiler records no device kernel."""
    events = device_kernels(fn, 1)
    if not events:
        return {"kernels": None, "device_ms": None, "conv_ms": None,
                "tf32_named": None}
    by_name = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {label}, device ms by kernel: {t:.3f} {name[:90]}",
              flush=True)
    return {"kernels": float(len(events)),
            "device_ms": sum(by_name.values()),
            "conv_ms": sum(t for name, t in by_name.items()
                           if any(k in name.lower()
                                  for k in CONV_KERNEL_PARTS)),
            "tf32_named": sum(1 for e in events if "tf32" in e.name.lower())}


def glow_conv_flops(batch, levels, K, hidden, channels, size, **_):
    """Multiply-adds x 2 of one forward's convolutions (each GlowBlock's
    3 x 3, 1 x 1, 3 x 3 net), counted from the shapes."""
    total = 0
    for i in range(levels):
        c = channels * 2 ** (levels + 1 - i)
        hw = (size // 2 ** (levels - i)) ** 2
        c1, c2 = (c + 1) // 2, c // 2
        macs = hw * (c1 * hidden * 9 + hidden * hidden + hidden * 2 * c2 * 9)
        total += K * macs
    return 2 * batch * total


def synthetic_images(g, n: int, size: int):
    """8-bit images from a seed: a random 4 x 4 colour field upsampled,
    with pixel noise, rounded to 0..255 (uint8)."""
    import torch
    import torch.nn.functional as tF

    low = torch.rand((n, 3, 4, 4), generator=g, device=DEVICE)
    img = tF.interpolate(low, size=size, mode="bilinear", align_corners=False)
    img = img + 0.05 * torch.randn(img.shape, generator=g, device=DEVICE)
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


def dequantize(g, q):
    import torch

    return (q.float() + torch.rand(q.shape, generator=g, device=q.device)) \
        / 256.0


def phase_glow(card: str, widths: dict, steps: int) -> dict:
    import contextlib
    import copy

    import torch

    from flowstate_tpu_torch.flows import nets
    from flowstate_tpu_torch.training import (
        TrainConfig, make_optimizer, make_train_step,
    )

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(81)
    flow = glow_flow(g, **widths)
    b = widths["batch"]
    data = synthetic_images(g, b * steps, widths["size"])
    cfg = TrainConfig(batch_size=b, lr=GLOW_LR, weight_decay=1e-5)
    opt = make_optimizer(cfg)
    step = make_train_step(flow, cfg, opt)
    state = [opt.init(list(flow.parameters()))]
    losses = []
    for i in range(steps):
        state[0], loss = step(state[0], dequantize(g, data[i * b:(i + 1) * b]))
        losses.append(loss)
    losses = torch.stack(losses).cpu()
    first, last = float(losses[:3].mean()), float(losses[-3:].mean())
    require(bool(torch.isfinite(losses).all()) and last < first,
            f"glow: loss {first} -> {last} over {steps} steps")
    x = dequantize(g, data[:b])

    def train_step():
        state[0], loss = step(state[0], x)
        return loss

    ms = median_ms(train_step, 5)
    for _ in range(3):            # the profiler may record nothing (F6)
        prof = step_kernels(train_step, "glow step")
        if prof["kernels"] is not None:
            break
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # TF32 allowed (PyTorch's default for cuDNN): a reading, not an option
    real, prev = nets._no_tf32, torch.backends.cudnn.allow_tf32
    nets._no_tf32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms = median_ms(train_step, 3)
        tf32 = step_kernels(train_step, "glow step with TF32")
    finally:
        nets._no_tf32, torch.backends.cudnn.allow_tf32 = real, prev
    require(prof["tf32_named"] == 0,
            f"glow: {prof['tf32_named']} kernels named TF32 in the step "
            f"(None: three profiles recorded no kernel)")
    flops = 3 * glow_conv_flops(**widths)   # forward, input and weight grads

    with torch.no_grad():
        lp = flow.log_prob(x)
        flow64 = copy.deepcopy(flow).double()
        lp64 = flow64.log_prob(x.double())
        del flow64
        f64_err = float(((lp.double() - lp64).abs() / (1 + lp64.abs())).max())
        z_list, ld = flow.inverse_and_log_det(x)
        x_back, ld_f = flow.forward_and_log_det(z_list)
        trip = float((x_back - x).abs().max())
        trip_ld = float(((ld + ld_f).abs() / (1 + ld.abs())).max())
        s = flow.sample(b, g)
    require(bool(torch.isfinite(lp).all()) and f64_err <= GLOW_F64_RTOL,
            f"glow: log_prob vs float64 {f64_err} of (1 + |log q|)")
    require(trip <= GLOW_TRIP_ATOL and trip_ld <= GLOW_TRIP_LD_RTOL,
            f"glow: round trip {trip}, log-dets {trip_ld}")
    require(tuple(s.shape) == (b, 3, widths["size"], widths["size"])
            and bool(torch.isfinite(s).all()), "glow: samples")
    dev, conv_dev = prof["device_ms"], prof["conv_ms"]

    def fmt(v, spec=".3f"):
        return "not_measured" if v is None else format(v, spec)

    out = {"ms": ms, **prof, "peak_gib": peak_gib, "tf32_ms": tf32_ms,
           "tf32": tf32, "conv_flop": flops, "loss_first": first,
           "loss_last": last}
    phase("20a glow", card=f"'{card}'", levels=widths["levels"],
          K=widths["K"], hidden=widths["hidden"], batch=b,
          image=f"3x{widths['size']}x{widths['size']}",
          params=sum(p.numel() for p in flow.parameters()), steps=steps,
          loss_first3=f"{first:.2f}", loss_last3=f"{last:.2f}",
          step_ms=f"{ms:.3f}", step_kernels=prof["kernels"],
          step_device_ms=fmt(dev), conv_device_ms=fmt(conv_dev),
          peak_gib=f"{peak_gib:.3f}", conv_gflop=f"{flops / 1e9:.1f}",
          conv_tflops_over_device=fmt(dev and flops / dev / 1e9, ".2f"),
          conv_tflops_over_conv_kernels=fmt(conv_dev and
                                            flops / conv_dev / 1e9, ".2f"),
          tf32_named_kernels=prof["tf32_named"],
          tf32_step_ms=f"{tf32_ms:.3f}",
          tf32_step_device_ms=fmt(tf32["device_ms"]),
          tf32_step_conv_device_ms=fmt(tf32["conv_ms"]),
          tf32_step_tf32_named_kernels=tf32["tf32_named"],
          log_q_vs_float64=f"{f64_err:.3g}", round_trip_err=f"{trip:.3g}",
          round_trip_log_det=f"{trip_ld:.3g}", samples=len(s),
          wall_s=f"{time.perf_counter() - t0:.1f}")
    del flow, state
    torch.cuda.empty_cache()
    return out


class _TwoModes:
    """normflows' ``TwoModes(2, 0.1)`` target with the proposal box that
    ``flows.rejection_sample`` needs."""

    n_dims = 2

    def __init__(self):
        from flowstate_tpu_torch import flows as F

        self.target = F.TwoModes(2.0, 0.1)

    def log_prob(self, z):
        return self.target.log_prob(z)


def update_lipschitz_(flow, n_iterations: int) -> None:
    """Each ``Residual`` layer's net ``update_lipschitz``, written into its
    parameters (normflows' ``utils.update_lipschitz(model, n)``)."""
    import torch

    from flowstate_tpu_torch.flows import Residual, tree_map

    for layer in flow.layers:
        if isinstance(layer.layer, Residual):
            tree = layer.params.tree()
            new = layer.layer.net.update_lipschitz(tree["net"], n_iterations)
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src), tree["net"], new)


def plain_series(jac, e, n: int):
    """sum_{k <= n} (-1)^(k+1) / k e . (J^T)^k e per sample, J (B, D, D)
    with J[b, i, j] = d g_i / d x_j, e (B, D): the truncated series that
    the ``series`` estimator computes, one vector-Jacobian product a
    term."""
    import torch

    v, total = e, torch.zeros_like(e[:, 0])
    for k in range(1, n + 1):
        v = torch.einsum("bij,bi->bj", jac, v)
        total = total + (-1.0) ** (k + 1) / k * (v * e).sum(dim=1)
    return total


def residual_log_dets(flow, x, g):
    """Inverse through ``flow``.  At each ``Residual`` layer: its series
    log-det on probes drawn from ``g``, held per sample against
    ``plain_series`` of its net's dense Jacobian on the same probes, taken
    on float64 copies of the tree and the input (the largest error of
    (1 + |log-det|) is returned), and the exact estimator's log-det at
    the same input.  Also the two log q, by the series and by the exact
    log-dets."""
    import dataclasses

    import torch

    from flowstate_tpu_torch.flows import Residual, tree_map
    from flowstate_tpu_torch.flows.residual import batch_jacobian

    series = exact = torch.zeros_like(x[:, 0])
    dense_err = 0.0
    for layer in reversed(flow.layers):
        if isinstance(layer.layer, Residual):
            res, tree = layer.layer, layer.params.tree()
            exact_layer = dataclasses.replace(res, estimator="exact",
                                              dim=x.shape[1])
            exact = exact + exact_layer._logdetgrad(tree, x)
            noise = res.draw(x, g)
            net64 = tree_map(lambda p: p.detach().double(), tree["net"])
            jac = batch_jacobian(lambda v: res.net.apply(net64, v),
                                 x.double())
            want = torch.stack([plain_series(jac, e.double(),
                                             res.n_power_series)
                                for e in noise[0]]).mean(dim=0)
            x, ld = layer.inverse(x, noise=noise)
            dense_err = max(dense_err, float(
                ((ld.double() - want).abs() / (1 + want.abs())).max()))
            series = series + ld
        else:
            x, ld = layer.inverse(x)
            series, exact = series + ld, exact + ld
    base = flow.base.log_prob(x)
    return series + base, exact + base, dense_err


def phase_residual_flow(card: str, widths: dict, steps: int) -> dict:
    import torch

    from flowstate_tpu_torch import flows as F

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(82)
    K, h, coeff = widths["K"], widths["hidden"], widths["coeff"]
    layers = []
    for _ in range(K):
        net = F.LipschitzMLP((2, h, h, 2), coeff=coeff)
        layers += [F.ParamLayer(F.Residual(net, estimator="series"), g,
                                device=DEVICE),
                   F.ParamLayer(F.ActNorm(2), g, device=DEVICE)]
    flow = F.NormalizingFlow(F.DiagGaussian(2, trainable=False), layers,
                             device=DEVICE)
    target = _TwoModes()
    opt = torch.optim.Adam(flow.parameters(), lr=1e-3, weight_decay=1e-5)
    b = widths["batch"]
    losses = []

    # TwoModes accepts a few percent of the proposal box, so 64 x 512
    # proposals leave several times the 512 taken (fewer would repeat some)
    def train_step():
        x = F.rejection_sample(target, b, g, DEVICE, oversample=64)
        loss = flow.forward_kld(x, include_base=True)
        if torch.isfinite(loss):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        losses.append(loss.detach())

    def update():
        update_lipschitz_(flow, RESIDUAL_LIP_ITERS)

    for _ in range(steps):
        train_step()
        update()
    ms = median_ms(train_step, 3)
    prof = per_call(train_step, 1)
    update_ms = median_ms(update, 3)
    update_prof = per_call(update, 1)
    losses = torch.stack(losses[:steps]).cpu()
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    require(bool(torch.isfinite(losses).all()) and last < first,
            f"residual flow: loss {first} -> {last} over {steps} steps")
    norm_ratio = 0.0
    for layer in flow.layers:
        if isinstance(layer.layer, F.Residual):
            for p in layer.params.tree()["net"]:
                w = layer.layer.net._normalized_w(p).detach()
                norm_ratio = max(norm_ratio, float(
                    torch.linalg.matrix_norm(w, ord=2)) / coeff)
    require(norm_ratio <= 1.0 + RESIDUAL_NORM_RTOL,
            f"residual flow: a normalised weight's norm {norm_ratio} x coeff")
    x = F.rejection_sample(target, b, g, DEVICE, oversample=64)
    with torch.no_grad():
        lq_series, lq_exact, dense_err = residual_log_dets(flow, x, g)
    require(dense_err <= RESIDUAL_SERIES_RTOL,
            f"residual flow: series log-dets against the dense Jacobian's "
            f"series {dense_err}")
    gap = (lq_series - lq_exact).double()
    mean_gap, se = float(gap.mean()), float(gap.std() / math.sqrt(b))
    lip = coeff ** 3                 # three normalised linears, LipSwish 1
    n = flow.layers[0].layer.n_power_series
    trunc = K * 2 * sum(lip ** k / k for k in range(n + 1, 200))
    require(bool(torch.isfinite(gap).all())
            and abs(mean_gap) <= 3 * se + trunc,
            f"residual flow: series - exact log q {mean_gap} +- {se}, "
            f"truncation bound {trunc}")
    with torch.no_grad():
        z = flow.base.sample(4096, g, DEVICE)
        xs = flow.forward(z)
        trip = float((flow.inverse(xs) - z).abs().max())
    require(bool(torch.isfinite(xs).all()) and trip <= RESIDUAL_TRIP_ATOL,
            f"residual flow: fixed-point round trip {trip}")
    out = {"ms": ms, **prof, "update_ms": update_ms,
           "update_kernels": update_prof["kernels"], "loss_first": first,
           "loss_last": last, "gap": mean_gap, "dense_err": dense_err,
           "trip": trip}
    phase("20b residual flow", card=f"'{card}'", K=K, hidden=h, batch=b,
          steps=steps, loss_first5=f"{first:.4f}", loss_last5=f"{last:.4f}",
          step_ms=f"{ms:.3f}", step_kernels=prof["kernels"],
          step_device_ms=("not_measured" if prof["device_ms"] is None
                          else f"{prof['device_ms']:.3f}"),
          update_lipschitz_ms=f"{update_ms:.3f}",
          update_lipschitz_kernels=update_prof["kernels"],
          max_norm_over_coeff=f"{norm_ratio:.6f}",
          series_minus_exact_mean=f"{mean_gap:.4f}",
          series_minus_exact_se=f"{se:.4f}",
          series_minus_exact_max=f"{float(gap.abs().max()):.4f}",
          truncation_bound=f"{trunc:.3f}",
          series_vs_dense=f"{dense_err:.3g}", round_trip_err=f"{trip:.3g}",
          wall_s=f"{time.perf_counter() - t0:.1f}")
    del flow
    return out


def dense_rows(fn, x):
    """The Jacobian of ``fn`` at one input ``x`` (1, ...), (n_out, n_in),
    row k by the gradient of output k, all rows in one batched pass."""
    import torch

    n = x[0].numel()
    xs = x.expand(n, *x.shape[1:]).clone().requires_grad_()
    out = fn(xs)
    eye = torch.eye(n, dtype=x.dtype, device=x.device).reshape(out.shape)
    (rows,) = torch.autograd.grad(out, xs, eye)
    return rows.reshape(n, n)


def induced_norms(g, out_f: int, in_f: int) -> dict:
    """``InducedNormLinear`` (its init, then 300 steps) for 2->2, 1->1,
    inf->inf and 1->inf: sigma = u . W v over the closed form (the top
    singular value, the largest column abs-sum, the largest row abs-sum,
    the largest |w_ij|), and sigma against ||W v||_q / ||v||_p, the norm
    ratio the final ``v`` attains."""
    import torch

    from flowstate_tpu_torch import flows as F

    inf = math.inf
    out = {}
    for dom, cod in ((2, 2), (1, 1), (inf, inf), (1, inf)):
        layer = F.InducedNormLinear(in_f, out_f, domain=dom, codomain=cod,
                                    coeff=0.9)
        p = layer.update_lipschitz(layer.init_params(g, device=DEVICE), 300)
        w, v = p["w"].double(), p["v"].double()
        closed = {(2, 2): lambda: torch.linalg.matrix_norm(w, ord=2),
                  (1, 1): lambda: w.abs().sum(0).max(),
                  (inf, inf): lambda: w.abs().sum(1).max(),
                  (1, inf): lambda: w.abs().max()}[(dom, cod)]()
        attained = (torch.linalg.vector_norm(w @ v, ord=cod)
                    / torch.linalg.vector_norm(v, ord=dom))
        sigma = abs(float(torch.dot(p["u"], p["w"] @ p["v"])))
        out[f"{dom}->{cod}"] = (sigma / float(closed),
                                abs(sigma / float(attained) - 1.0))
    return out


def float_leaves(tree) -> list:
    from flowstate_tpu_torch.flows import tree_map

    out = []
    tree_map(lambda p: out.append(p) if p.is_floating_point() else None,
             tree)
    return out


def grad_error(loss, tree, x) -> float:
    """The gradient of ``loss(tree, x)`` with respect to the float leaves
    of ``tree`` in float32, against the same on float64 copies of
    ``tree`` and ``x``: the largest over the leaves of max |diff| over
    max |float64|, that scale held at least 1e-3 of the whole gradient's
    largest entry (a converged power vector ``u`` has a gradient some
    1e-5 of the weights', nearly cancelled, so float32 loses its digits;
    a leaf the loss does not reach reads its bare difference)."""
    import torch

    from flowstate_tpu_torch.flows import tree_map

    grads = []
    for dtype in (torch.float32, torch.float64):
        t = tree_map(lambda p: p.detach().to(dtype).requires_grad_()
                     if p.is_floating_point() else p, tree)
        grads.append(torch.autograd.grad(
            loss(t, x.detach().to(dtype)), float_leaves(t),
            allow_unused=True, materialize_grads=True))
    floor = 1e-3 * max(float(b.abs().max()) for b in grads[1])
    err = 0.0
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), floor)
        diff = float((a.double() - b).abs().max())
        err = max(err, diff / scale if scale > 0 else diff)
    return err


def conv_derivative_error(g, batch=8, c_in=12, c_out=64, size=16) -> float:
    """``nets.conv2d`` in float32 against native ``F.conv2d`` in float64
    on the same inputs (3 x 3, padding 1, stride 1 and 2): the output y,
    the gradients of L = sum(r y^2) with respect to x and w (the
    backward), and those of s = sum(a dL/dx) + sum(b dL/dw) (the double
    backward), each as max |diff| over max |float64|; the largest."""
    import torch
    import torch.nn.functional as tF

    from flowstate_tpu_torch.flows.nets import conv2d

    def rand(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    x, w = rand(batch, c_in, size, size), rand(c_out, c_in, 3, 3) / 10.0
    a, b = rand(*x.shape), rand(*w.shape)
    err = 0.0
    for stride in (1, 2):
        r = rand(batch, c_out, (size - 1) // stride + 1,
                 (size - 1) // stride + 1)
        got = []
        for conv, dtype in ((conv2d, torch.float32),
                            (tF.conv2d, torch.float64)):
            xd = x.to(dtype).requires_grad_()
            wd = w.to(dtype).requires_grad_()
            y = conv(xd, wd, stride=stride, padding=1)
            gx, gw = torch.autograd.grad((r.to(dtype) * y * y).sum(),
                                         (xd, wd), create_graph=True)
            hx, hw = torch.autograd.grad(
                (a.to(dtype) * gx).sum() + (b.to(dtype) * gw).sum(),
                (xd, wd))
            got.append((y, gx, gw, hx, hw))
        for u, v in zip(*got):
            u, v = u.detach().double(), v.detach()
            err = max(err, float((u - v).abs().max() / v.abs().max()))
    return err


def lipschitz_grad_errors(g, net, block, params, x, noise) -> dict:
    """Float32 derivatives against float64 (``CONV_GRAD_RTOL``): the conv
    alone against native ``F.conv2d``; the gradient of the series loss
    -mean(log-det) + mean(y^2) / 2 of the ``InducedNormCNN`` block and of
    a ``LipschitzCNN`` block of the same widths (the power series'
    vector-Jacobian products differentiated again: the conv's double
    backward); the gradient of a ``GlowBlock(12, 256)`` loss on 16 x 16
    images, its zero-initialised last conv set random so every conv has a
    gradient."""
    import dataclasses

    import torch

    from flowstate_tpu_torch import flows as F

    def series_loss(blk):
        def loss(tree, xd):
            nd = (noise[0].to(xd.dtype), noise[1])
            y, ld = blk.inverse({"net": tree}, xd, noise=nd)
            return -ld.mean() + 0.5 * (y * y).mean()
        return loss

    c, s = x.shape[1], x.shape[-1]
    lcnn = F.LipschitzCNN(net.channels, net.kernel_size, (s, s), coeff=0.9)
    lparams = lcnn.update_lipschitz(lcnn.init_params(g, device=DEVICE), 50)
    glow = F.GlowBlock(c, 256)
    gparams = glow.init_params(g, device=DEVICE)
    last = gparams["net"][-1]["w"]
    gparams["net"][-1]["w"] = 0.01 * torch.randn(last.shape, generator=g,
                                                 device=DEVICE)
    xg = torch.randn((16, c, s, s), generator=g, device=DEVICE)

    def glow_loss(tree, xd):
        z, ld = glow.inverse(tree, xd)
        return -ld.mean() + 0.5 * (z * z).mean()

    return {"conv": conv_derivative_error(g),
            "induced_cnn_series": grad_error(series_loss(block),
                                             params["net"], x),
            "lipschitz_cnn_series": grad_error(
                series_loss(dataclasses.replace(block, net=lcnn)),
                lparams, x),
            "glow_block": grad_error(glow_loss, gparams, xg)}


def phase_lipschitz(card: str, linear=((12, 16), (96, 128)),
                    conv_field=(4, 6), cnn: dict = None) -> dict:
    """``InducedNormLinear`` at each (out, in) of ``linear``: sigma a norm
    ratio that its ``v`` attains (within ``LIP_ATTAINED``), at most the
    closed form, and at 2->2 the closed form (within ``LIP_CLOSED``); off
    2->2 the iteration is a local ascent whose 11 starts may stop below
    the largest column or row, so the ratio there is printed.  The 3 x 3
    conv's sigma against its dense operator; an ``InducedNormCNN``
    residual block; float32 derivatives against float64
    (``lipschitz_grad_errors``)."""
    import torch

    from flowstate_tpu_torch import flows as F
    from flowstate_tpu_torch.flows import tree_map

    t0 = time.perf_counter()
    cnn = cnn or LIP_CNN
    g = torch.Generator(device=DEVICE)
    g.manual_seed(83)
    norms = {}
    for out_f, in_f in linear:
        res = induced_norms(g, out_f, in_f)
        require(all(r <= 1.0 + LIP_CLOSED and e <= LIP_ATTAINED
                    for r, e in res.values())
                and res["2->2"][0] >= 1.0 - LIP_CLOSED,
                f"lipschitz: sigma over the closed form, and against the "
                f"attained ratio, at {out_f}x{in_f}: {res}")
        norms[f"{out_f}x{in_f}"] = res
    c, hw = conv_field
    conv = F.InducedNormConv2d(c, c, 3, spatial_dims=(hw, hw), coeff=0.9)
    p = conv.update_lipschitz(conv.init_params(g, device=DEVICE), 1000)
    dense = dense_rows(lambda v: conv._conv(p["w"].double(), v),
                       torch.zeros((1, c, hw, hw), dtype=torch.float64,
                                   device=DEVICE))
    conv_exact = float(torch.linalg.matrix_norm(dense, ord=2))
    conv_sigma = float(torch.dot(p["u"], conv._wv(p["w"], p["v"])))
    conv_err = abs(conv_sigma / conv_exact - 1.0)
    require(conv_err <= LIP_CONV_RTOL,
            f"lipschitz: conv sigma {conv_sigma}, dense norm {conv_exact}")

    # an InducedNormCNN residual block, its last conv back at full scale
    s = cnn["size"]
    net = F.InducedNormCNN(cnn["channels"], cnn["kernels"], (s, s),
                           coeff=cnn["coeff"])
    block = F.Residual(net, estimator="series")
    params = net.init_params(g, device=DEVICE)
    params[-1]["w"] = params[-1]["w"] * 1000.0
    params = {"net": net.update_lipschitz(params, 50)}
    x = torch.randn((cnn["batch"], cnn["channels"][0], s, s), generator=g,
                    device=DEVICE)
    noise = block.draw(x, g)
    with torch.no_grad():
        y, ld = block.inverse(params, x, noise=noise)
        x_back, ld_f = block.forward(params, y, noise=noise)
    trip = float((x_back - x).abs().max())
    require(trip <= RESIDUAL_TRIP_ATOL and bool(torch.isfinite(ld).all()),
            f"lipschitz: the CNN block's round trip {trip}")
    # the series on the first two images against the same series from the
    # dense Jacobian (e J^k e with JAX's vjp order), and the exact log-det
    series_err, gaps = 0.0, []
    net64 = tree_map(lambda p: p.detach().double(), params["net"])
    for i in range(2):
        jac = dense_rows(lambda v: net.apply(net64, v), x[i:i + 1].double())
        e = noise[0][0, i].reshape(1, -1).double()
        want = float(plain_series(jac[None], e, block.n_power_series)[0])
        series_err = max(series_err, abs(float(ld[i]) - want)
                         / (1.0 + abs(want)))
        eye = torch.eye(e.shape[1], dtype=torch.float64, device=DEVICE)
        gaps.append(float(ld[i]) - float(torch.linalg.slogdet(eye + jac)[1]))
    require(series_err <= LIP_CNN_SERIES_RTOL,
            f"lipschitz: the block's series vs the dense J's {series_err}")
    grads = lipschitz_grad_errors(g, net, block, params, x[:8],
                                  (noise[0][:, :8], noise[1]))
    require(all(v <= CONV_GRAD_RTOL for v in grads.values()),
            f"lipschitz: float32 derivatives against float64 {grads}")
    phase("20c lipschitz", card=f"'{card}'",
          **{f"sigma_over_closed_{size}_{k}": f"{r:.6f}"
             for size, res in norms.items() for k, (r, _) in res.items()},
          conv_field=f"{c}x{hw}x{hw}", conv_sigma_err=f"{conv_err:.3g}",
          cnn_block="x".join(map(str, cnn["channels"])),
          cnn_images=f"{cnn['batch']}x{cnn['channels'][0]}x{s}x{s}",
          round_trip_err=f"{trip:.3g}", series_vs_dense=f"{series_err:.3g}",
          series_minus_exact=",".join(f"{v:.4f}" for v in gaps),
          **{f"grad_vs_float64_{k}": f"{v:.3g}" for k, v in grads.items()},
          wall_s=f"{time.perf_counter() - t0:.1f}")
    return {"norms": norms, "conv_err": conv_err, "trip": trip,
            "series_err": series_err, "gaps": gaps, "grads": grads}


def phase_image_residual(card: str, glow: dict = None,
                         glow_steps: int = GLOW_STEPS,
                         residual: dict = None,
                         residual_steps: int = RESIDUAL_STEPS,
                         lipschitz: dict = None) -> dict:
    """The image, residual and Lipschitz flows on the card: (a) Glow at
    normflows' widths, trained, timed (ms, kernels, device ms, peak
    memory, the convolutions' FLOP rate; one step with TF32 allowed) and
    checked (float64 log q, the round trip, samples); (b) the residual
    flow example trained with the Lipschitz update, its normalised
    weights, the series log-det against the exact one, the fixed-point
    samples; (c) the induced-norm layers and the convolutions' float32
    derivatives against float64.  No kernel of the port runs
    here: these flows are plain PyTorch (the JAX package reaches no
    Pallas kernel for them)."""
    t0 = time.perf_counter()
    out = {"glow": phase_glow(card, glow or GLOW, glow_steps),
           "residual": phase_residual_flow(card, residual or RESIDUAL,
                                           residual_steps),
           "lipschitz": phase_lipschitz(card, **(lipschitz or {}))}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 20 took {out['wall_s']:.1f} s", flush=True)
    return out


# Phase 21: the gate and sampler tools and the demos.  The quadrature's
# spreads: the numpy tool's ΔF at 4e6 points and the sector weights at
# 2e6, over seeds 0-7 on a CPU (``python -m flowstate_tpu_torch.tools.
# exact_free_energy --device cpu --spread_seeds 8``, whose CPU path takes
# the numpy tool's draws): ΔF 1.4842 mean, 0.0041 standard deviation.
QUAD_POINTS = 100_000         # numpy draws held on the card against the CPU
QUAD_LZ_ATOL = 1e-4           # K2's ln Z and ΔF against the float64 plain
# K2 against the float64 plain at (QUAD_M, 3): the hard core agrees but
# where the closest pair's r^2 lies within this of the core's, float32's
# rounding
QUAD_CORE_R2_ATOL = 1e-6
QUAD_M = 4_000_000            # the card's own draws for ΔF and a sector
QUAD_SECTOR_M = 2_000_000
QUAD_SEEDS = 4                # the particle-level ΔF's quadratures
QUAD_SPREADS = 4              # gates: within 4 spreads
QUAD_DF_SD = 0.0041
QUAD_SECTOR_SD = {"AAA": 0.00015, "AAB": 0.00035, "ABB": 0.00036,
                  "BBB": 0.00027}
EXACT_SECTORS = {"AAA": 0.0378, "AAB": 0.3011, "ABB": 0.4939,
                 "BBB": 0.1672}   # SECTORS.md
EXACT_PARTICLE_DF = 0.3926        # ESS.md
# the tools at cut sizes (the cuts: PERF.md section 4)
TOOL_RUNS = {
    "ess_check": ["--rounds", "60", "--epochs", "2", "--train_cap",
                  "15360"],
    "sampler_bench": ["--rounds", "24", "--moves_per_round", "20",
                      "--epochs", "1", "--mala_equilibration", "300",
                      "--hmc_equilibration", "50"],
    "within_well_bench": ["--systems", "3:256,32:64", "--rounds", "12",
                          "--mala_equilibration", "300",
                          "--hmc_equilibration", "50"],
    "pt_mbar_oracle": ["--n_list", "8"],
}
# the demos at full size where they fit, else at their smoke size
DEMO_SMOKE = {"mcmc_demo": False, "tempering_demo": False, "nf_demo": True,
              "hybrid_algorithm_1_demo": True,
              "hybrid_algorithm_2_demo": True}


def timed_s(fn):
    """(fn(), seconds), the card synchronised after."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """(fn(), (K1, K2) launches by their wrappers' counts in the call)."""
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair as cp

    cm.LAUNCHES = cp.LAUNCHES = 0
    out = fn()
    return out, (cm.LAUNCHES, cp.LAUNCHES)


def hold_k2_at_quadrature_shape(spec, points, k2_fn) -> dict:
    """K2 against its plain version in float64 on the same (M, 3, 2)
    float32 points: the overlaps (+inf) in the same rows, bar rows whose
    closest pair sits on the hard core within float32's rounding; the
    finite energies within PAIR_RTOL of their terms' magnitudes plus
    PAIR_ATOL; ln Z within QUAD_LZ_ATOL."""
    import torch

    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.ops import min_image
    from flowstate_tpu_torch.ops.box import squared_norm
    from flowstate_tpu_torch.tools import exact_free_energy as ef

    e_k = k2_fn(spec, points)[0].double()
    exact = points.double()
    e_p = cp.total_energy_virial_plain(spec, exact)[0]
    inf_k, inf_p = torch.isinf(e_k), torch.isinf(e_p)
    split = torch.nonzero(inf_k != inf_p).flatten()
    if split.numel():
        x = exact[split]
        d = min_image(x[:, :, None, :] - x[:, None, :, :], spec.box)
        r2 = squared_norm(d) + torch.eye(x.shape[1], device=x.device) * 1e9
        gap = (r2.amin((1, 2)) - spec.hard_core ** 2).abs()
        require(bool((gap < QUAD_CORE_R2_ATOL).all()),
                f"K2 at M={points.shape[0]}: overlap rows differ off the "
                f"hard core: {split[:8].tolist()}, |r^2 - core^2| "
                f"{gap[:8].tolist()}")
    ok = ~(inf_k | inf_p)
    e_mag = pair_magnitudes(spec, exact)[0]
    de = (e_k - e_p)[ok].abs()
    e_err = float(de.max()) if de.numel() else 0.0
    require(bool((de <= PAIR_RTOL * e_mag[ok] + PAIR_ATOL).all()),
            f"K2 at M={points.shape[0]}: energies differ by {e_err}")
    lz_err = abs(ef.log_mean_boltzmann(e_k) - ef.log_mean_boltzmann(e_p))
    require(lz_err < QUAD_LZ_ATOL,
            f"K2 at M={points.shape[0]}: ln Z {lz_err:.3g} from the float64 "
            "plain version")
    return dict(e_err=e_err, lz_err=lz_err,
                overlaps=int(inf_p.sum()), split_overlaps=int(split.numel()))


def phase_quadrature(m: int = QUAD_M, sector_m: int = QUAD_SECTOR_M,
                     seeds: int = QUAD_SEEDS,
                     points: int = QUAD_POINTS) -> dict:
    """(a) K2's quadrature against the float64 plain version on the same
    numpy draws; the card's own draws against the exact values; the wall
    seconds of each against the CPU's (numpy draws, float64)."""
    import numpy as np
    import torch

    from flowstate_tpu_torch.tools import exact_free_energy as ef

    lz = {}
    for region in ("A", "B") + ef.SECTORS:
        pts = ef.disk_points(region, points, np.random.default_rng(21), "cpu")
        lz[region] = (ef.log_partition_of_points(pts.to(DEVICE)),
                      ef.log_partition_of_points(pts))
    lz_err = max(abs(a - b) for a, b in lz.values())
    df_err = abs((lz["B"][0] - lz["A"][0]) - (lz["B"][1] - lz["A"][1]))
    require(lz_err < QUAD_LZ_ATOL and df_err < QUAD_LZ_ATOL,
            f"K2's ln Z {lz_err:.3g} / ΔF {df_err:.3g} from the float64 "
            "plain version")

    def card_run():
        df, df_s = timed_s(lambda: ef.exact_delta_f(m, 0, DEVICE))
        probs, sec_s = timed_s(lambda: ef.exact_sector_probs(sector_m, 0,
                                                             DEVICE))
        (p_df, p_sem), p_s = timed_s(lambda: ef.exact_particle_df(
            m, seeds, DEVICE))
        return dict(delta_f=df, delta_f_s=df_s, sectors=probs,
                    sectors_s=sec_s, particle_df=p_df, particle_sem=p_sem,
                    particle_s=p_s)

    res, launches = counted(card_run)
    # K2 alone at the quadrature's shape: (M, 3) float32, the wells added
    from flowstate_tpu_torch.ops import cuda_pair as cp
    from flowstate_tpu_torch.tools.n_scaling import (
        k2_bound, pairs_inside_cutoff,
    )

    spec = reference_spec(3)
    big = ef.disk_points("A", m, np.random.default_rng(22), DEVICE).to(
        torch.float32).contiguous()
    k2_fn = (cp.total_energy_virial_kernel if DEVICE == "cuda"
             else cp.total_energy_virial_plain)
    k2_ms = cuda_ms(lambda: k2_fn(spec, big), 5)
    k2_bound_ms, k2_bound_by = k2_bound(m, 3, 2,
                                        pairs_inside_cutoff(spec, big))
    at_m = hold_k2_at_quadrature_shape(spec, big, k2_fn)
    del big
    require(abs(res["delta_f"] - PT_EXACT_DF) < QUAD_SPREADS * QUAD_DF_SD,
            f"ΔF {res['delta_f']:.4f} vs {PT_EXACT_DF}")
    for k, want in EXACT_SECTORS.items():
        require(abs(res["sectors"][k] - want)
                < QUAD_SPREADS * QUAD_SECTOR_SD[k],
                f"sector {k} {res['sectors'][k]:.5f} vs {want}")
    require(abs(res["particle_df"] - EXACT_PARTICLE_DF)
            < QUAD_SPREADS * res["particle_sem"],
            f"particle ΔF {res['particle_df']:.5f} +- "
            f"{res['particle_sem']:.5f} vs {EXACT_PARTICLE_DF}")
    require(launches[1] >= 2 + 4 + 4 * seeds, f"K2 launches {launches}")
    # the CPU: the numpy tool's draws and float64 energies
    _, cpu_df_s = timed_s(lambda: ef.exact_delta_f(m, 0, "cpu"))
    _, cpu_sec_s = timed_s(lambda: ef.exact_sector_probs(sector_m, 0, "cpu"))
    _, cpu_seed_s = timed_s(lambda: ef.exact_sector_probs(m, 0, "cpu"))
    res.update(lz_err=lz_err, df_err=df_err, launches=launches, at_m=at_m,
               cpu_delta_f_s=cpu_df_s, cpu_sectors_s=cpu_sec_s,
               cpu_particle_seed_s=cpu_seed_s, k2_ms=k2_ms,
               k2_bound_ms=k2_bound_ms, k2_bound_by=k2_bound_by)
    phase("21a quadrature", points=points, lnZ_err=f"{lz_err:.3g}",
          dF_err=f"{df_err:.3g}", at_M=f"e_err={at_m['e_err']:.3g} "
          f"lnZ_err={at_m['lz_err']:.3g} overlaps={at_m['overlaps']} "
          f"split={at_m['split_overlaps']}", dF=f"{res['delta_f']:.4f}",
          dF_gate=f"1.490+-{QUAD_SPREADS * QUAD_DF_SD:.4f}",
          sectors="/".join(f"{res['sectors'][k]:.4f}" for k in ef.SECTORS),
          particle_dF=f"{res['particle_df']:.4f}+-{res['particle_sem']:.4f}",
          card_s=f"{res['delta_f_s']:.3f}/{res['sectors_s']:.3f}/"
                 f"{res['particle_s']:.3f}",
          cpu_s=f"{cpu_df_s:.3f}/{cpu_sec_s:.3f}/{cpu_seed_s:.3f}x{seeds}",
          K1_K2=f"{launches[0]}/{launches[1]}",
          K2_ms_at_M=f"{k2_ms:.4f}", K2_bound_ms=f"{k2_bound_ms:.4f}",
          K2_bound_by=k2_bound_by)
    return res


def in_dir(fn):
    """fn() run in a fresh temporary working directory."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            return fn(tmp)
        finally:
            os.chdir(cwd)


def phase_kernel_check(argv=()) -> dict:
    """(b) ``move_kernel_check``: PALLAS.md's gates, K1 and the plain
    engine on one budget."""
    from flowstate_tpu_torch.tools import move_kernel_check

    res, launches = counted(lambda: move_kernel_check.main(
        list(argv) + ["--device", DEVICE]))
    require(abs(res["acceptance_pallas"] - res["acceptance_xla"]) < 0.02,
            f"acceptance {res['acceptance_pallas']} vs "
            f"{res['acceptance_xla']}")
    require(res["energy_drift_max"] < 1e-2,
            f"drift {res['energy_drift_max']}")
    require(res["energy_mean_sigma_distance"] < 4.0,
            f"energy {res['energy_mean_sigma_distance']} sigma")
    require(res["virial_poisoned"], "virial not poisoned")
    require(res["autopad_ok"], f"C=1000 drift {res['odd_chains_drift']}")
    require(res["n12_drift_max"] < 1e-2, f"N=12 drift {res['n12_drift_max']}")
    require(res["n128_drift_per_particle"] < 1e-2
            and 0.05 < res["n128_acceptance"] < 0.95,
            f"N=128 {res['n128_drift_per_particle']} / "
            f"{res['n128_acceptance']}")
    require(res["ok"], "move_kernel_check not ok")
    res["launches"] = launches
    phase("21b move_kernel_check", chains=res["chains"],
          moves=res["moves_per_chain"],
          acceptance=f"{res['acceptance_pallas']}/{res['acceptance_xla']}",
          drift_max=f"{res['energy_drift_max']:.3g}",
          sigma=res["energy_mean_sigma_distance"],
          moves_per_s=f"{res['pallas_moves_per_s']:.4g}/"
                      f"{res['xla_moves_per_s']:.4g}",
          K1_K2=f"{launches[0]}/{launches[1]}")
    return res


def phase_tool_runs(runs: dict = None) -> dict:
    """(c) ``ess_check``, ``sampler_bench``, ``within_well_bench`` and
    ``pt_mbar_oracle`` at cut sizes: every row finite, the acceptances in
    range, the MBAR error bar finite; the gates the cut cannot carry are
    printed, not asserted."""
    import importlib

    out = {}
    for name, argv in (runs or TOOL_RUNS).items():
        tool = importlib.import_module(f"flowstate_tpu_torch.tools.{name}")
        res, launches = counted(lambda: in_dir(lambda tmp: tool.main(
            argv + ["--device", DEVICE])))
        if name == "ess_check":
            require(0.0 <= res["hybrid_acceptance"] <= 1.0
                    and math.isfinite(res["hybrid_ess"])
                    and math.isfinite(res["hybrid_delta_f"]),
                    f"ess_check {res}")
            note = f"gate={'PASS' if res['value'] is not None else 'not met'}"
        elif name == "sampler_bench":
            require(len(res["rows"]) == 5, f"rows {res['rows']}")
            for row in res["rows"]:
                require(0.0 <= row["acceptance"] <= 1.0
                        and math.isfinite(row["well_ess"])
                        and math.isfinite(row["wall_s"]), f"row {row}")
            for row in res["rows"][:3]:
                require(0.0 < row["acceptance"] < 1.0, f"row {row}")
            note = " ".join(f"{r['sampler'].split(' ')[0]}:"
                            f"{r['acceptance']}/{r['wall_s']}s"
                            for r in res["rows"])
        elif name == "within_well_bench":
            for row in res["rows"]:
                require(0.0 < row["acceptance"] < 1.0
                        and math.isfinite(row["energy_ess"])
                        and math.isfinite(row["meanx_ess"]), f"row {row}")
            note = " ".join(f"N{r['n']}:{r['sampler']}:{r['acceptance']}/"
                            f"{r['energy_ess_per_s']}" for r in res["rows"])
        else:
            for s in res["systems"].values():
                require(math.isfinite(s["df_particle_mbar"])
                        and math.isfinite(s["df_particle_mbar_sem"])
                        and s["df_particle_mbar_sem"] > 0, f"pt {s}")
            note = " ".join(f"N{n}:{s['df_particle_mbar']}+-"
                            f"{s['df_particle_mbar_sem']}"
                            for n, s in res["systems"].items())
        require(launches[0] > 0 and launches[1] > 0,
                f"{name} K1/K2 launches {launches}")
        out[name] = dict(result=res, launches=launches)
        phase(f"21c {name}", K1_K2=f"{launches[0]}/{launches[1]}",
              cut=" ".join(argv), numbers=note)
    return out


def phase_demos(smoke: dict = None) -> dict:
    """(d) the five demos, checked for the files the JAX demos' tests
    check."""
    import importlib

    import numpy as np

    out = {}
    for name, small in (smoke or DEMO_SMOKE).items():
        demo = importlib.import_module(f"flowstate_tpu_torch.demos.{name}")

        def go(tmp):
            t0 = time.perf_counter()
            res = demo.main(smoke=small, device=DEVICE)
            written = os.path.join(tmp, "demo_results")
            files = os.listdir(written) if os.path.isdir(written) else []
            return res, files, time.perf_counter() - t0

        (res, files, wall), launches = counted(lambda: in_dir(go))
        run_id = {"hybrid_algorithm_1_demo": "a1_demo",
                  "hybrid_algorithm_2_demo": "a2_demo"}.get(name, name)
        if name in ("tempering_demo",):
            require(bool(np.isfinite(res)), f"{name} gave {res}")
        elif name == "nf_demo":
            require(bool(np.isfinite(res).all()), f"nf_demo loss {res}")
        else:
            require(res is not None, f"{name} returned nothing")
        if name != "tempering_demo":
            require(run_id in files, f"{name} wrote {files}")
        out[name] = dict(launches=launches, wall_s=wall, smoke=small)
        phase(f"21d {name}", smoke=small, wall_s=f"{wall:.1f}",
              K1_K2=f"{launches[0]}/{launches[1]}")
    return out


def phase_host_share(chains: int = 256, mala_moves: int = 20,
                     local_moves: int = 150) -> dict:
    """(e) ms (CUDA events, median of 7), device kernels and device ms
    (profiler) of a MALA round of ``mala_moves`` moves and of a hybrid
    round (K1's ``local_moves`` moves, then a big move of the K=15 flow
    at A1's widths) at the tools' ``chains``, and the host-bound share 1 -
    device ms / ms of each."""
    import torch

    from flowstate_tpu_torch.flows import build_circular_flow
    from flowstate_tpu_torch.mcmc import nf_big_moves, run_moves_auto
    from flowstate_tpu_torch.mcmc.mala import run_mala
    from flowstate_tpu_torch.tools.ess_check import equilibrated_state

    spec = reference_spec(3)
    s0 = equilibrated_state(spec, chains, 5, DEVICE, 1000)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    flow = build_circular_flow(3, 2, 5.0, K=15, hidden_units=256,
                               num_bins=32, generator=g, device=DEVICE)
    mala0 = s0.replace(max_disp=torch.full_like(s0.max_disp, 0.02))
    rounds = {
        "mala": lambda: run_mala(spec, 1.0, mala0, mala_moves),
        "hybrid": lambda: nf_big_moves(
            spec, 1.0, run_moves_auto(spec, 1.0, s0, local_moves), flow,
            5.0, g)}
    out = {}
    for name, fn in rounds.items():
        ms = median_ms(fn)
        prof = per_call(fn)
        share = (1.0 - prof["device_ms"] / ms
                 if prof["device_ms"] is not None else None)
        out[name] = dict(ms=ms, host_share=share, **prof)
    phase("21e host share", chains=chains,
          **{f"{k}_ms_kernels_device_ms_share":
             f"{v['ms']:.3f}/{v['kernels']}/{v['device_ms']}/"
             f"{v['host_share']}" for k, v in out.items()})
    return out


def phase_tools(card: str, quad: dict = None, kernel_check=(),
                runs: dict = None, demos: dict = None) -> dict:
    """Phase 21: the port's gate and sampler tools and its demos on the
    card.  Returns each tool's (K1, K2) launches under ``launches``."""
    t0 = time.perf_counter()
    q = phase_quadrature(**(quad or {}))
    kc = phase_kernel_check(kernel_check)
    tools = phase_tool_runs(runs)
    dem = phase_demos(demos)
    share = phase_host_share()
    launches = {"quadrature": q["launches"],
                "move_kernel_check": kc["launches"],
                **{k: v["launches"] for k, v in tools.items()},
                **{k: v["launches"] for k, v in dem.items()}}
    wall = time.perf_counter() - t0
    print(f"  phase 21 took {wall:.1f} s", flush=True)
    return {"quadrature": q, "kernel_check": kc, "tools": tools,
            "demos": dem, "host_share": share, "launches": launches,
            "wall_s": wall}


# the N-scaling studies at cut sizes and full widths: Algorithm 1's flow
# (K=15, hidden 256, 32 bins), the blocked flow (K = 4 and 10, hidden
# 128, 16 bins), Algorithm 2's preset (K=23, hidden 128); the cuts:
# PERF.md section 4
STUDY_RUNS = {
    "hybrid_n_scaling": ["--n_list", "8,16", "--chains", "60",
                         "--collect_rounds", "10", "--pt_rounds", "30",
                         "--rounds", "20", "--acc_rounds", "5",
                         "--epochs", "1"],
    "n_mitigation": ["--rungs", "base,transformer,gnn", "--chains", "60",
                     "--collect_rounds", "10", "--acc_rounds", "5"],
    "blocked_wall": ["--n_list", "8", "--k_list", "1,2", "--chains", "60",
                     "--pt_rounds", "150", "--rounds", "20",
                     "--acc_rounds", "5", "--epochs", "1"],
    "blocked_depth": ["--K_list", "4,10", "--chains", "60",
                      "--pt_rounds", "150", "--rounds", "20",
                      "--acc_rounds", "5", "--epochs", "1"],
    "alpha_study": ["--cycles", "3", "--alphas", "1.0,0.5",
                    "--output_dir", "alpha_study"],
}
STUDY_RUNG_EPOCHS = 1      # n_mitigation's rungs (40-200 epochs), cut
STUDY_WALL_S = 240         # phase 22's bound (about 95 s alone)
# the JAX package's TPU readings the cut cannot reach, printed beside the
# port's: hybrid_n_scaling.json (N=8), blocked_depth.json (K=4, 10)
STUDY_JAX = {"n8_local_acceptance": 0.00071, "n8_pt_df": 0.0546,
             "depth_acceptance": {4: 0.16847, 10: 0.22102}}


def finite(*xs) -> bool:
    return all(x is not None and math.isfinite(x) for x in xs)


def in_unit(x) -> bool:
    return x is not None and 0.0 <= x <= 1.0


def check_study(name: str, res: dict) -> str:
    """Require what a cut run of study ``name`` must show (every row
    finite where the JAX tool's would be, acceptances in [0, 1]); return
    the gates the cut cannot carry, for printing only."""
    if name == "hybrid_n_scaling":
        notes = []
        for s in res["systems"]:
            pt = s["pt"]
            require(finite(pt["df_particle"], pt["well_ess"], pt["wall_s"])
                    and all(in_unit(a) for a in pt["edge_acceptance"]),
                    f"N={s['n']} PT {pt}")
            for tag in ("local_trained", "pt_trained"):
                v = s[tag]
                require(in_unit(v["big_move_acceptance"])
                        and finite(v["df_particle"], v["df_vs_pt"],
                                   v["well_ess_upper_bound"], v["wall_s"])
                        and v["crossings"] >= 0, f"N={s['n']} {tag} {v}")
                # a training set smaller than a batch trains no step
                # (JAX's loss is NaN there too)
                if v["train_configs"] >= 512:
                    require(finite(v["fkld_first"], v["fkld_last"]),
                            f"N={s['n']} {tag} loss {v}")
                notes.append(f"N{s['n']}:{tag.split('_')[0]}:"
                             f"acc={v['big_move_acceptance']}:"
                             f"dF_vs_pt={v['df_vs_pt']}:"
                             f"reliable={v['ess_reliable']}")
        return (" ".join(notes) + f" jax_N8_local_acc="
                f"{STUDY_JAX['n8_local_acceptance']} jax_N8_pt_dF="
                f"{STUDY_JAX['n8_pt_df']}")
    if name == "n_mitigation":
        rows = res["systems"][-1]["rows"]
        for row in rows:
            require("error" not in row, f"rung {row}")
            require(in_unit(row["acceptance"])
                    and in_unit(row["ratio_log_frac_inf"])
                    and finite(row["fkld_first"], row["fkld_last"]),
                    f"rung {row}")
            if row["ratio_log_frac_inf"] < 1.0:
                require(finite(row["ratio_log_mean"], row["ratio_log_std"],
                               row["ratio_log_p99"]), f"rung {row}")
        return " ".join(f"{r['rung']}:acc={r['acceptance']}:log_r="
                        f"{r['ratio_log_mean']}+-{r['ratio_log_std']}"
                        for r in rows)
    if name == "blocked_wall":
        notes = []
        for s in res["systems"]:
            require(finite(s["pt"]["df_particle"]), f"PT {s['pt']}")
            require(len(s["blocks"]) > 0, f"no block size ran: {s}")
            for row in s["blocks"]:
                require(in_unit(row["acceptance"])
                        and finite(row["loss_first"], row["loss_last"],
                                   row["df_particle"],
                                   row["well_ess_upper_bound"]),
                        f"N={s['n']} k={row['k']} {row}")
                notes.append(f"N{s['n']}:k{row['k']}:acc="
                             f"{row['acceptance']}(predicted "
                             f"{row['predicted_acceptance']}):dF_vs_pt="
                             f"{row['df_vs_pt']}")
        return " ".join(notes)
    if name == "blocked_depth":
        for row in res["rows"]:
            require(in_unit(row["acceptance"])
                    and finite(row["loss_last"], row["df_particle"],
                               row["blocked_moves_per_s"])
                    and row["blocked_moves_per_s"] > 0, f"K={row['K']} {row}")
        return " ".join(f"K{r['K']}:acc={r['acceptance']}(jax "
                        f"{STUDY_JAX['depth_acceptance'].get(r['K'])}):"
                        f"moves_per_s={r['blocked_moves_per_s']:.4g}"
                        for r in res["rows"])
    for run in res["runs"]:
        require(in_unit(run["big_move_acceptance_final"])
                and finite(run["delta_f_mean"], *run["loss_per_cycle"]),
                f"alpha {run['alpha']}: {run}")
    return " ".join(f"alpha{r['alpha']}:p_acc={r['big_move_acceptance_final']}"
                    f":dF={r['delta_f_mean']:.4f}:wall={r['wall_s']}s"
                    for r in res["runs"])


def phase_studies(card: str, runs: dict = None,
                  rung_epochs: int = STUDY_RUNG_EPOCHS) -> dict:
    """Phase 22: the five N-scaling studies at cut sizes (``runs``, each
    in a fresh working directory), K1 and K2 launched by each; returns
    each study's result and (K1, K2) launches, and the phase's wall."""
    import importlib

    t0 = time.perf_counter()
    out = {}
    for name, argv in (runs or STUDY_RUNS).items():
        tool = importlib.import_module(f"flowstate_tpu_torch.tools.{name}")
        rungs = getattr(tool, "RUNGS", None)
        if rungs is not None:
            tool.RUNGS = {k: dict(v, epochs=rung_epochs)
                          for k, v in rungs.items()}
        try:
            (res, wall), launches = counted(lambda: in_dir(
                lambda tmp: timed_s(lambda: tool.main(
                    argv + ["--device", DEVICE]))))
        finally:
            if rungs is not None:
                tool.RUNGS = rungs
        note = check_study(name, res)
        require(launches[0] > 0 and launches[1] > 0,
                f"{name} K1/K2 launches {launches}")
        out[name] = dict(result=res, launches=launches, wall_s=wall)
        phase(f"22 {name}", card=repr(card), wall_s=f"{wall:.1f}",
              K1_K2=f"{launches[0]}/{launches[1]}", cut=" ".join(argv),
              not_asserted=note)
    wall = time.perf_counter() - t0
    require(wall < STUDY_WALL_S, f"phase 22 took {wall:.1f} s")
    print(f"  phase 22 took {wall:.1f} s", flush=True)
    return {"studies": out, "wall_s": wall,
            "launches": {k: v["launches"] for k, v in out.items()}}


def layer_slices(stacked: dict, k: int) -> list:
    """The K per-layer trees of a stacked tree (leaves (K, ...)), as an
    unstacked flow holds them."""
    def take(tree, i):
        if isinstance(tree, dict):
            return {key: take(v, i) for key, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(take(v, i) for v in tree)
        return tree[i]

    return [take(stacked, i) for i in range(k)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import flowstate_tpu_torch  # noqa: F401  (fails outside the checkout)

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    err = phase_pathwise()
    err_k2 = phase_pair_kernel()
    phase_statistics()
    phase_exact_physics()
    main_path = phase_main_path()
    timing = phase_timing(card)
    for n, samples in SINGLE_RUN_NS:
        phase_single_run(card, n=n, samples=samples)
    k3 = phase_issue_rate(card)
    n_scaling = phase_n_scaling(card)
    phase_sweep()
    phase_flow(card)
    a1 = phase_algorithm1(card)
    a2 = phase_algorithm2(card)
    blocked = phase_blocked(card)
    samplers = phase_samplers(card)
    nets = phase_nets(card)
    multi = phase_multi_device(card)
    zoo = phase_zoo(card)
    phase_image_residual(card)
    tools = phase_tools(card)
    studies = phase_studies(card)
    launches_tools = {**tools["launches"], **studies["launches"]}
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    k1, k2 = timing["k1"], timing["k2"]["main_path"]
    print(json.dumps({"kernels": [{
        "name": "metropolis_moves",
        "route": "cuda",
        "source": "flowstate_tpu_torch/csrc/metropolis_moves.cu",
        "replaces": "flowstate_tpu/mcmc/pallas_metropolis.py:106",
        "launches": a1["launches"],
        "launches_mcmc_only": main_path["launches"],
        "launches_a2": a2["launches"],
        "launches_blocked": {"a1": blocked["launches_a1"][0],
                             "a2": blocked["launches_a2"][0]},
        "launches_pt": samplers["launches_pt"][0],
        "launches_nets": {k: nets[k]["a1"]["launches"][0] for k in NETS},
        "launches_multi": multi["launches"][0],
        "launches_zoo": zoo["launches"][0],
        "launches_tools": {k: v[0] for k, v in launches_tools.items()},
        "max_abs_err": max(err, samplers["max_abs_err"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "pair_energy",
        "route": "cuda",
        "source": "flowstate_tpu_torch/csrc/pair_energy.cu",
        "replaces": "flowstate_tpu/ops/pallas_pair.py:33",
        "launches": a1["launches_k2"],
        "launches_mcmc_only": main_path["launches_k2"],
        "launches_a2": a2["launches_k2"],
        "launches_blocked": {"a1": blocked["launches_a1"][1],
                             "a2": blocked["launches_a2"][1]},
        "launches_pt": samplers["launches_pt"][1],
        "launches_mala_hmc": samplers["launches_mala_hmc"],
        "launches_nets": {k: nets[k]["a1"]["launches"][1] for k in NETS},
        "launches_multi": multi["launches"][1],
        "launches_zoo": zoo["launches"][1],
        "launches_tools": {k: v[1] for k, v in launches_tools.items()},
        "max_abs_err": err_k2,
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "issue_rate",
        "route": "cuda",
        "source": "flowstate_tpu_torch/csrc/issue_rate.cu",
        "replaces": "tools/n_scaling.py:74",
        "launches": n_scaling["launches_k3"],
        "max_abs_err": k3["err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
