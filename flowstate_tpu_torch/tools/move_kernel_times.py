"""The move kernel K1 alone on the card: what the compiler made of it and
its time per launch at the shapes the paths give it.

    python -m flowstate_tpu_torch.tools.move_kernel_times [--single_run]

Prints JSON lines: the card and its power limit; ptxas's registers and
spills per K1 instance; the opcode mix of each instance's move loop
(``cuobjdump -sass``); then, per shape, the milliseconds of one launch by
CUDA events, exact and fast math, and moves per second.  The shapes: the
main path's launch (100 chains x 150 moves, N=3, two wells), the
throughput shape (16,384 x 1000), the single run's (128 x 200, N=1024) and
the N-scaling tool's chains at N = 8 ... 1024.  With ``--single_run`` also
the wall seconds of the single-run CLI at N=1024, 128 chains.

It calls only what every version of the port has (``build.build``,
``run_moves_kernel``, ``single_run.main``), so the same file, copied into
another checkout's ``flowstate_tpu_torch/tools/`` (with
``kernels/sass.py``), times that checkout's kernel: two versions are
compared inside one call on one card, in turns.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from flowstate_tpu_torch.kernels import build
from flowstate_tpu_torch.kernels.sass import loop_mix
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.initialise import (
    init_alternating_wells, initialise_fcc,
)
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.ops import SystemSpec
from flowstate_tpu_torch.tools.common import card, double_well_spec
from flowstate_tpu_torch.tools.n_scaling import chains_for, k1_bound

# (label, N, wells, chains, moves per launch, timed launches)
SHAPES = [("main_path", 3, True, 100, 150, 200),
          ("throughput", 3, True, 16384, 1000, 20),
          ("single_run", 1024, False, 128, 200, 3)] + [
    (f"n_scaling_{n}", n, False, chains_for(n), 256 * max(1, 32 // n), 3)
    for n in (8, 32, 128, 512, 1024)]


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def launch_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events, after a warm call."""
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


def shape_state(n: int, wells: bool, chains: int):
    """The reference double-well system (alternating wells start) or pure
    LJ at density 0.3 from the lattice, moved 256 times off its start."""
    if wells:
        spec = double_well_spec(n)
        pos, _ = init_alternating_wells(chains, n, 0.03)
        max_disp = 0.65
    else:
        lattice, box = initialise_fcc(n, 0.3, 1.0)
        spec = SystemSpec.create(n, box, num_wells=0)
        pos = np.broadcast_to(lattice, (chains, n, 2)).copy()
        max_disp = 0.5
    state = init_chain_state(spec, torch.as_tensor(pos, device="cuda"), 0,
                             max_disp)
    return spec, cm.run_moves_kernel(spec, 1.0, state, 256)


def single_run_wall() -> float:
    """Wall seconds of the single-run CLI at N=1024, 128 chains (2000
    equilibration and 8000 production moves, sampled every 200)."""
    from flowstate_tpu_torch.experiments import single_run

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        single_run.main([
            "--temperature", "1.0", "--num_particles", "1024",
            "--initial_rho", "0.3", "--num_wells", "0",
            "--initialisation_type", "all", "--num_chains", "128",
            "--equilibration_steps", "2000", "--adjusting_frequency", "500",
            "--production_steps", "8000", "--sampling_frequency", "200",
            "--initial_max_displacement", "1.0", "--output_path", out,
            "--experiment_id", "single_run", "--seed", "0",
            "--device", "cuda"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="copied into every line")
    ap.add_argument("--single_run", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the move kernel runs on a CUDA device; torch "
                           "finds none")
    emit(label=args.label, card=card("cuda"))
    res = build.build()
    lines = res.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "metropolis_moves_kernel" in line:
            emit(label=args.label, ptxas=" ".join(
                s.strip() for s in lines[i:i + 4]))
    for inst, m in sorted(loop_mix(res.paths["metropolis_moves"],
                                   "metropolis_moves_kernel").items()):
        emit(label=args.label, instance=inst,
             function_instructions=sum(m["all"].values()),
             loop_instructions=sum(m["loop"].values()),
             loop=dict(m["loop"].most_common()))
    for name, n, wells, chains, moves, reps in SHAPES:
        spec, state = shape_state(n, wells, chains)
        row = {"label": args.label, "shape": name, "n": n, "chains": chains,
               "moves": moves,
               "bound_ms": k1_bound(chains, n, spec.num_wells, moves)[0]}
        for key, fast in (("ms", False), ("fast_ms", True)):
            row[key] = launch_ms(lambda: cm.run_moves_kernel(
                spec, 1.0, state, moves, fast_math=fast), reps)
        row["moves_per_s"] = chains * moves / row["ms"] * 1e3
        emit(**row)
    if args.single_run:
        single_run_wall()                          # warm: the second is timed
        emit(label=args.label, single_run_wall_s=single_run_wall())


if __name__ == "__main__":
    main()
