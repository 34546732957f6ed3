"""The pair-energy kernel K2 alone on the card, and the main path's
production block around it: time per call, device kernels per call and
launches per call at the shapes the paths give K2.

    python -m flowstate_tpu_torch.tools.pair_kernel_times [--single_run]

Prints JSON lines: the card and its power limit; ptxas's registers and
spills of each K2 kernel; then, per shape, the milliseconds of one call by
CUDA events over back-to-back calls, the device time per call and the
device kernels per call by the profiler, the launches ``LAUNCHES`` counts
per call, and the plain version's milliseconds where the shape is one a
path times against it.  The shapes: the main path's resync (100 chains,
N=3, two wells), the single run's (128, 1024), and the N-scaling tool's
chains at N = 8 ... 1024 (lattices at density 0.3, jittered by a numpy
seed).  Then the main path's production block (150 moves of 100 chains
through K1, a resync through K2, a sample): ms per block, device busy ms,
device kernels per block and the card's idle share.  With
``--single_run`` also the wall seconds of the single-run CLI at N=1024.

It calls only what every version of the port has (``build.build``,
``total_energy_virial_kernel``, ``total_energy_virial_plain``,
``run_production_kernel``), so the same file, copied into another
checkout's ``flowstate_tpu_torch/tools/``, times that checkout's kernel:
two versions are compared inside one call on one card, in turns.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from flowstate_tpu_torch.kernels import build
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.initialise import (
    init_alternating_wells, initialise_fcc,
)
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.ops import SystemSpec
from flowstate_tpu_torch.ops import cuda_pair as cp
from flowstate_tpu_torch.tools.move_kernel_times import (
    emit, launch_ms, single_run_wall,
)
from flowstate_tpu_torch.tools.common import (
    card, device_events, double_well_spec,
)
from flowstate_tpu_torch.tools.n_scaling import chains_for

# (label, N, chains, timed calls, plain version's timed calls or 0)
SHAPES = [("main_path", 3, 100, 1000, 100),
          ("single_run", 1024, 128, 200, 5)] + [
    (f"n_scaling_{n}", n, chains_for(n), 100, 0)
    for n in (8, 32, 128, 512, 1024)]


def batch(n: int, chains: int):
    """The main path's alternating-wells start at N=3, else the lattice at
    density 0.3 jittered by +-0.05 (numpy seed n), wrapped; on the card."""
    if n == 3:
        pos, _ = init_alternating_wells(chains, n, 0.03)
        return double_well_spec(n), torch.as_tensor(
            pos, dtype=torch.float32, device="cuda")
    lattice, box = initialise_fcc(n, 0.3, 1.0)
    rng = np.random.default_rng(n)
    pos = lattice + rng.uniform(-0.05, 0.05, size=(chains, n, 2))
    pos = np.stack([pos[..., 0] % box.size_x, pos[..., 1] % box.size_y], -1)
    return (SystemSpec.create(n, box, num_wells=0),
            torch.as_tensor(pos, dtype=torch.float32, device="cuda"))


def production_block(blocks: int = 100) -> dict:
    """The main path's production block (150 moves of 100 chains through
    K1, a resync through K2, one observable sample): host ms per block
    over ``blocks`` blocks, then of a profiled window of as many the
    card's busy time, its kernels per block, its idle share (1 - busy /
    wall) and the device microseconds per block by kernel name."""
    spec = double_well_spec(3)
    pos, _ = init_alternating_wells(100, 3, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device="cuda"), 5,
                             0.65)

    def run(s):
        s, _ = cm.run_production_kernel(spec, 1.0, s, blocks, 150)
        torch.cuda.synchronize()
        return s

    state = run(state)                           # warm
    t0 = time.perf_counter()
    state = run(state)
    block_ms = (time.perf_counter() - t0) * 1e3 / blocks
    launches = cm.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = cm.LAUNCHES - launches
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / blocks)
    return {"block_ms": block_ms,
            "profiled_wall_ms_per_block": wall_us / 1e3 / blocks,
            "device_busy_ms_per_block": busy_us / 1e3 / blocks,
            "device_kernels_per_block": len(kernels) / blocks,
            "idle_share": 1.0 - busy_us / wall_us if kernels else None,
            "move_kernels": sum("metropolis_moves_kernel" in e.name
                                for e in kernels),
            "move_launches": launches,
            "us_per_block_by_kernel": by_name}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="copied into every line")
    ap.add_argument("--single_run", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the pair kernel runs on a CUDA device; torch "
                           "finds none")
    emit(label=args.label, card=card("cuda"))
    lines = build.build().log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "pair_" in line:
            emit(label=args.label, ptxas=" ".join(
                s.strip() for s in lines[i:i + 4]))
    for name, n, chains, reps, plain_reps in SHAPES:
        spec, pos = batch(n, chains)

        def call():
            return cp.total_energy_virial_kernel(spec, pos)

        before = cp.LAUNCHES
        call()
        row = {"label": args.label, "shape": name, "n": n, "chains": chains,
               "launches_per_call": cp.LAUNCHES - before,
               "ms": launch_ms(call, reps)}
        events = device_events(call, 20)
        row["device_ms"] = sum(e.time_range.elapsed_us()
                               for e in events) / 1e3 / 20
        row["device_kernels_per_call"] = len(events) / 20
        row["kernels"] = sorted({e.name for e in events})
        if plain_reps:
            row["plain_ms"] = launch_ms(
                lambda: cp.total_energy_virial_plain(spec, pos), plain_reps)
        emit(**row)
    emit(label=args.label, shape="production_block", **production_block())
    if args.single_run:
        single_run_wall()                          # warm: the second is timed
        emit(label=args.label, single_run_wall_s=single_run_wall())


if __name__ == "__main__":
    main()
