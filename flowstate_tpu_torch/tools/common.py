"""What the gate and sampler tools share: the device check, the card's
name and power limit, a timer of host loops, the reference system and
its equilibration length, the ``--evidence`` option and the writer of its
JSON."""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from flowstate_tpu_torch.ops import Box, SystemSpec

EVIDENCE_DIR = os.path.join("results", "evidence")
# the JAX tools' equilibration: kernel moves, the displacement adapted
# every 500
EQUILIBRATION_MOVES = 5000


def tool_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the
    tools default to the card and run on the CPU only when asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on "
                           "the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no engine for device {device}")
    return device


def card(device) -> str:
    """``name, power.limit`` as nvidia-smi gives them for a CUDA device,
    else the device's type."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class HostLoopTimer:
    """Seconds of a host loop: CUDA events around it on the card, the
    host clock on the CPU.  ``with HostLoopTimer(dev) as t: ...``, then
    ``t.seconds``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = float("nan")

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            torch.cuda.synchronize()
            self.seconds = self._start.elapsed_time(self._end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0
        return False


def double_well_spec(n: int = 3, num_wells: int = 2,
                     v0=(-10.0, -10.5)) -> SystemSpec:
    """The reference system at N particles: rho 0.03, r0 1.2, k 15."""
    return SystemSpec.create(n, Box.from_density(n, 0.03, 1.0),
                             num_wells=num_wells, V0_list=tuple(v0),
                             r0=1.2, k=15.0)


def add_common_args(parser, tool: str, seed: int = 0) -> None:
    """``--device``, ``--seed`` and ``--evidence [PATH]`` (without a path:
    ``results/evidence/<tool>_torch_data.json``)."""
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=seed)
    parser.add_argument(
        "--evidence", nargs="?", default=None,
        const=os.path.join(EVIDENCE_DIR, f"{tool}_torch_data.json"),
        help="write the result's JSON here")


def finite_or_none(value):
    """JSON has no NaN or infinity: such a float becomes null."""
    if isinstance(value, dict):
        return {k: finite_or_none(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite_or_none(v) for v in value]
    if isinstance(value, (np.floating, np.integer, np.bool_)):
        value = value.item()
    if isinstance(value, float) and not np.isfinite(value):
        return None
    return value


def write_evidence(path, result: dict) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(finite_or_none(result), f, indent=1)
