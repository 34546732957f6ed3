"""What both traffic drivers share: the program's experiment
configuration from a cell's configuration and traffic, the draws of the
check's sample from the seed, and the reference's system energies on the
device in blocks."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import metropolis as ref_mh
from benchmark.reference import system as ref_system


def experiment_config(config: dict, traffic: dict, seed: int, **extra):
    """The program's ``ExperimentConfig`` of the cell: the configuration's
    system and schedule, the traffic's chains, ``seed`` as the chains'
    seed."""
    from flowstate_tpu_torch.utils.config import ExperimentConfig

    s = config["system"]
    return ExperimentConfig(
        num_chains=traffic["chains"], master_seed=seed,
        num_particles=s["num_particles"], num_dim=2,
        temperature=s["temperature"], rho=s["rho"], aspect_ratio=1.0,
        num_wells=2, V0_list=tuple(s["V0_list"]), r0=s["r0"],
        k_val=s["k_val"], **config["schedule"], **extra)


def rng(seed: int, salt: int) -> np.random.Generator:
    """The check's draws (its chains and steps) from the seed."""
    return np.random.default_rng([seed, salt])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def energies(sys: ref_system.System, positions, device,
             block: int = 65536, dtype=torch.float64) -> tuple:
    """Reference (energy, virial), as float64 numpy, of (B, N, 2)
    positions (numpy or a tensor), computed on ``device`` in blocks, in
    float64 unless a control asks for less."""
    e_out, w_out = [], []
    for i in range(0, len(positions), block):
        p = torch.as_tensor(positions[i:i + block]).to(device, torch.float64)
        p = p.to(dtype)
        e, w = ref_system.energy_virial(sys, p)
        e_out.append(e.double().cpu().numpy())
        w_out.append(w.double().cpu().numpy())
    return np.concatenate(e_out), np.concatenate(w_out)


def max_gap(a, b) -> float:
    """The largest |a - b| over pairs where both are finite; infinite
    where exactly one of a pair is finite, or nothing is compared."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any() or not fa.any():
        return float("inf")
    return float(np.abs(a[fa] - b[fa]).max())


class Clock:
    """Seconds since the window opened."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


# the control's precision for what is float32 outside products (the move
# kernel, the pair energies): bfloat16, put in the program's place
LOWER = torch.bfloat16
# the share of the move kernel's sampled chains that the check must
# compare (the others met a decision within rounding of a tie)
MIN_COMPARED = 0.5


def k1_gap(sys, seed: int, chains, calls: int, moves: int, start,
           moved, max_disp, lower: bool) -> tuple:
    """``(gap, tie share)`` of one move-kernel launch of ``chains``: the
    largest distance of a particle in ``moved`` (the program's positions
    after the launch) from the reference's float64 replay of it from
    ``start``, over the chains without a tie; infinite where fewer than
    ``MIN_COMPARED`` of them are compared.  With ``lower`` the replay in
    bfloat16 stands in the program's place."""
    replayed, tie = ref_mh.replay(sys, seed & 0xFFFFFFFF, chains, calls,
                                  moves, start, max_disp)
    if lower:
        moved, _ = ref_mh.replay(sys, seed & 0xFFFFFFFF, chains, calls,
                                 moves, start, max_disp, LOWER, LOWER)
    gap = np.nan_to_num(ref_mh.position_gap(moved, replayed, sys.box),
                        nan=np.inf)
    share = float(tie.mean())
    if 1.0 - share < MIN_COMPARED:
        return float("inf"), share
    return float(gap[~tie].max(initial=0.0)), share
