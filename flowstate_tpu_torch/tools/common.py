"""What the gate, sampler and N-scaling tools share: the device check,
the card's name and power limit, a timer of host loops, the reference
system and its equilibration length, the ``--evidence`` option and the
writer of its JSON; for the N-scaling studies, their equilibration
length, the timed loop and the hybrid run's summary."""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from flowstate_tpu_torch.analysis.ess import (
    crossing_bound_ess, multichain_ess,
)
from flowstate_tpu_torch.ops import Box, SystemSpec

EVIDENCE_DIR = os.path.join("results", "evidence")
# the JAX tools' equilibration: kernel moves, the displacement adapted
# every 500
EQUILIBRATION_MOVES = 5000
# the N-scaling studies': the half-lattice starts at N = 16 and 32 are
# some 150-300 sweeps from the packed-well equilibrium at 5000
SPLIT_EQUILIBRATION_MOVES = 20_000


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
                     v0=(-10.0, -10.5), r0: float = 1.2) -> SystemSpec:
    """The reference system at N particles: rho 0.03, r0 1.2, k 15."""
    return SystemSpec.create(n, Box.from_density(n, 0.03, 1.0),
                             num_wells=num_wells, V0_list=tuple(v0),
                             r0=r0, k=15.0)


def timed(fn, device, warmup=None):
    """``(fn(), seconds)``: ``warmup()`` first, untimed, then ``fn()``
    once by a ``HostLoopTimer``.

    The JAX tools' ``_timed`` runs the whole program three times, two
    untimed runs for XLA's compile, and each run starts from the same
    state and keys, so all three give one output.  Here nothing is
    compiled per program: one round of the loop warms it up (``warmup``,
    as ``ess_check`` does), and the timed loop runs once."""
    if warmup is not None:
        warmup()
    with HostLoopTimer(device) as timer:
        out = fn()
    return out, timer.seconds


def ess_fields(ess: float, ess_ub: float, dt: float,
               reliable: bool) -> dict:
    """Headline ESS fields with the unreliable-estimator suppression rule.

    When the observed crossings cannot support the rank-normalized
    estimate (``reliable=False``), the estimator fields are nulled and the
    crossing-rate bound is the headline (SAMPLERS.md's convention)."""
    out = {
        "well_ess": round(ess, 1) if reliable else None,
        "well_ess_per_s": round(ess / dt, 2) if reliable else None,
        "well_ess_upper_bound": round(ess_ub, 1),
        "well_ess_per_s_upper_bound": round(ess_ub / dt, 2),
        "ess_reliable": reliable,
    }
    if not reliable:
        out["well_ess_suppressed_estimate"] = round(ess, 1)
    return out


def particle_df_after(n_a, n_b, burn: int) -> float:
    """ln(sum n_B / sum n_A) of (C, T) particle counts in the wells over
    the rounds after ``burn``, each sum taken as at least 1."""
    return float(np.log(max(float(n_b[:, burn:].sum()), 1.0)
                        / max(float(n_a[:, burn:].sum()), 1.0)))


def hybrid_summary(w, n_a, n_b, dt: float, df_ref: float) -> dict:
    """A hybrid run's fields from its (C, T) well labels and particle
    counts in the wells: after a burn of T // 3 rounds the well label's
    ESS and crossing-rate bound (``ess_fields``), the crossings over all
    rounds, the particle-level ΔF = ln(sum n_B / sum n_A) and its
    distance from ``df_ref`` (the PT oracle's); the estimate counts as
    reliable with 20 crossings or more and an ESS within its bound."""
    w, n_a, n_b = (np.asarray(x) for x in (w, n_a, n_b))
    burn = w.shape[1] // 3
    ess = float(multichain_ess(w[:, burn:]))
    ess_ub = float(crossing_bound_ess(w[:, burn:]))
    crossings = int(np.sum(np.abs(np.diff(w, axis=1)) > 0.5))
    df = particle_df_after(n_a, n_b, burn)
    reliable = crossings >= 20 and ess <= ess_ub
    return {**ess_fields(ess, ess_ub, dt, reliable),
            "wall_s": round(dt, 2), "crossings": crossings,
            "df_particle": round(df, 4), "df_vs_pt": round(df - df_ref, 4)}


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
