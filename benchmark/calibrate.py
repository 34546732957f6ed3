"""The check's readings, for setting its limits: runs of a cell in one
process, seed after seed, each through ``harness.run_cell`` with its own
set-up, a short window at the cell's load and the check, with the
program as it is (``sound``), as the check's control (``lower``: float32
products on TF32 tensor cores, and the reference in bfloat16 in the
program's place for what is float32 outside products: the move kernel's
positions, the pair energies), with the residual net's own
``compute_dtype="bfloat16"`` (``bf16``), or with a fault of
``faults.py`` planted (``fault:<name>``).  Prints one JSON line per run:
``correct``, each number compared beside its limit, and the check's
notes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --modes sound,lower,fault:frozen --seconds 3
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def tf32(enabled: bool):
    """float32 products on TF32 tensor cores for the block, if
    ``enabled``; the previous settings come back."""
    import torch

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if enabled:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def reading(bench, cell: str, seed: int, mode: str, seconds: float,
            device) -> dict:
    """One run of ``cell`` in ``mode``: its verdict and the numbers
    compared."""
    from benchmark import faults
    from benchmark.harness import run_cell

    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    control = None if fault or mode == "sound" else mode
    plant = (faults.planted(fault, device) if fault
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with plant, tf32(mode == "lower"):
        result = run_cell(bench, cell, seed, seconds, False, device, t0,
                          control=control)
    return {"cell": cell, "seed": seed, "mode": mode,
            "correct": result["correct"], "attempted": result["attempted"],
            "notes": result["notes"], "checks": result["checks"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default="sound")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from benchmark.loader import Benchmark

    bench = Benchmark(ROOT)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(bench, args.workload, seed, mode,
                                     args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
