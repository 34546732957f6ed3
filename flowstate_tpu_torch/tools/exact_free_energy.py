"""Exact ΔF = ln(Z_B / Z_A) of the double-well system by quadrature.

Port of ``tools/exact_free_energy.py``, the oracle behind every 1.490 of
the repository.  ln Z of a region (all three particles in one well, or a
sector such as "AAB") is logmeanexp(-beta U) over points drawn uniformly
in the classification disks (radius 1.1 r0); the disk volumes cancel.  The
energies of all M configurations are one call of the pair-energy kernel
on the card (float32, the wells added, a hard-core overlap +inf) and the
plain float64 energy on the CPU; the weights are taken in float64 after
it.  Overlaps weigh zero but stay in the denominator of the mean.

Draws: on the CPU the JAX tool's own numpy stream (so the CPU path
reproduces its numbers), on the card a ``torch.Generator`` of the card.

    python -m flowstate_tpu_torch.tools.exact_free_energy [--samples 4000000]
        [--sectors] [--particle] [--device cuda] [--seed 0] [--evidence]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from flowstate_tpu_torch.ops.cuda_pair import (
    total_energy_virial_kernel, total_energy_virial_plain,
)
from flowstate_tpu_torch.tools.common import (
    add_common_args, card, double_well_spec, sync, tool_device,
    write_evidence,
)

L = 10.0
R0, K_STEEP = 1.2, 15.0
V0 = (-10.0, -10.5)
RADIUS = 1.1 * R0
CENTERS = {"A": np.array([L / 4, L / 2]), "B": np.array([3 * L / 4, L / 2])}
BETA = 1.0
SECTORS = ("AAA", "AAB", "ABB", "BBB")
MULTIPLICITY = {"AAA": 1, "AAB": 3, "ABB": 3, "BBB": 1}
KERNEL_CHUNK = 1 << 24      # configurations per pair-energy launch


def _assignment(region: str) -> str:
    return region * 3 if region in CENTERS else region


def disk_points(region: str, m: int, rng, device) -> torch.Tensor:
    """(m, 3, 2) float64 points, particle i uniform in the disk of well
    ``assignment[i]``, on ``device``.  ``rng``: a numpy Generator (the JAX
    tool's stream: per particle m radii, then m angles) or a
    ``torch.Generator`` on ``device``."""
    pts = []
    for a in _assignment(region):
        c = CENTERS[a]
        if isinstance(rng, np.random.Generator):
            u = torch.as_tensor(rng.random(m), device=device)
            th = torch.as_tensor(rng.random(m) * 2 * np.pi, device=device)
        else:
            u = torch.rand(m, generator=rng, device=device,
                           dtype=torch.float64)
            th = torch.rand(m, generator=rng, device=device,
                            dtype=torch.float64) * (2 * np.pi)
        rr = RADIUS * torch.sqrt(u)
        pts.append(torch.stack([c[0] + rr * torch.cos(th),
                                c[1] + rr * torch.sin(th)], 1))
    return torch.stack(pts, 1)


def configuration_energy(points: torch.Tensor) -> torch.Tensor:
    """(m,) float64 total energies of (m, 3, 2) points: the pair-energy
    kernel on float32 copies on the card, the plain energy in float64 on
    the CPU."""
    spec = double_well_spec(3)
    if points.device.type == "cuda":
        out = [total_energy_virial_kernel(
            spec, points[i:i + KERNEL_CHUNK].to(torch.float32).contiguous())[0]
            for i in range(0, points.shape[0], KERNEL_CHUNK)]
        return torch.cat(out).double()
    if points.device.type == "cpu":
        return total_energy_virial_plain(spec, points.double(), 2 ** 24)[0]
    raise ValueError(f"no pair-energy engine for device {points.device}")


def log_mean_boltzmann(energy: torch.Tensor) -> float:
    """logmeanexp(-beta U) in float64; a point with U = +inf weighs zero
    and counts in the mean."""
    w = -BETA * energy.double()
    finite = torch.isfinite(w)
    m0 = w[finite].max()
    vals = torch.where(finite, torch.exp(torch.where(finite, w, m0) - m0),
                       torch.zeros_like(w))
    return float(m0 + torch.log(vals.mean()))


def log_partition_of_points(points: torch.Tensor) -> float:
    """ln Z (+ a constant that cancels) of a region from its points."""
    return log_mean_boltzmann(configuration_energy(points))


def _rng(seed: int, device: torch.device):
    if device.type == "cpu":
        return np.random.default_rng(seed)
    return torch.Generator(device=device).manual_seed(seed)


def log_partition(region: str, m: int, rng, device="cuda") -> float:
    """ln Z of ``region`` ("A", "B" or a 3-letter sector) over ``m``
    points drawn from ``rng`` (see ``disk_points``)."""
    return log_partition_of_points(disk_points(region, m, rng,
                                               tool_device(device)))


def exact_delta_f(samples: int = 4_000_000, seed: int = 0,
                  device="cuda") -> float:
    device = tool_device(device)
    rng = _rng(seed, device)
    return (log_partition("B", samples, rng, device)
            - log_partition("A", samples, rng, device))


def sector_log_z(samples: int = 2_000_000, seed: int = 0,
                 device="cuda") -> dict:
    """ln Z of every sector, its multiplicity included."""
    device = tool_device(device)
    rng = _rng(seed, device)
    return {pat: log_partition(pat, samples, rng, device)
            + np.log(MULTIPLICITY[pat]) for pat in SECTORS}


def sector_probs_from_log_z(lz: dict) -> dict:
    mx = max(lz.values())
    z = {k: np.exp(v - mx) for k, v in lz.items()}
    tot = sum(z.values())
    probs = {k: float(v / tot) for k, v in z.items()}
    probs["dF_pure"] = float(lz["BBB"] - lz["AAA"])
    return probs


def exact_sector_probs(samples: int = 2_000_000, seed: int = 0,
                       device="cuda") -> dict:
    """Equilibrium probabilities of the four in-well sectors (AllA, 2A1B,
    1A2B, AllB) and the pure-sector ΔF, by per-sector quadrature."""
    return sector_probs_from_log_z(sector_log_z(samples, seed, device))


def particle_df_from_probs(p: dict) -> float:
    """Particle-level ΔF = ln(E[n_B] / E[n_A]) of the sector weights."""
    n_b = p["AAB"] * 1 + p["ABB"] * 2 + p["BBB"] * 3
    n_a = p["AAA"] * 3 + p["AAB"] * 2 + p["ABB"] * 1
    return float(np.log(n_b / n_a))


def exact_particle_df(samples: int = 4_000_000, seeds: int = 4,
                      device="cuda"):
    """Particle-level ΔF over ``seeds`` independent quadratures: (mean,
    standard error of the mean) (``tools/ess_check.py::exact_particle_df``,
    whose converged value is 0.3926 +- 0.0003)."""
    vals = [particle_df_from_probs(exact_sector_probs(samples, seed, device))
            for seed in range(seeds)]
    return (float(np.mean(vals)),
            float(np.std(vals, ddof=1) / np.sqrt(len(vals))))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--samples", type=int, default=4_000_000)
    parser.add_argument("--sectors", action="store_true",
                        help="also the exact 4-sector probabilities")
    parser.add_argument("--particle", action="store_true",
                        help="also the particle-level ΔF over 4 seeds")
    parser.add_argument("--spread_seeds", type=int, default=0,
                        help="also ΔF and the sector weights at seeds 0 "
                             "... K-1, with their standard deviations")
    add_common_args(parser, "exact_free_energy")
    args = parser.parse_args(argv)
    device = tool_device(args.device)

    result = {"metric": "exact_free_energy", "card": card(device),
              "samples": args.samples, "seed": args.seed}
    sync(device)
    t0 = time.perf_counter()
    result["delta_f"] = exact_delta_f(args.samples, args.seed, device)
    sync(device)
    result["delta_f_s"] = time.perf_counter() - t0
    print(f"EXACT dF = ln(Z_B/Z_A) = {result['delta_f']:.4f}")
    if args.sectors:
        t0 = time.perf_counter()
        p = exact_sector_probs(args.samples // 2, args.seed, device)
        sync(device)
        result["sectors_s"] = time.perf_counter() - t0
        result["sector_probs"] = p
        print("EXACT sector probabilities: "
              + ", ".join(f"{k}={p[k]:.4f}" for k in SECTORS))
    if args.particle:
        t0 = time.perf_counter()
        mean, sem = exact_particle_df(args.samples, 4, device)
        sync(device)
        result.update(particle_df=mean, particle_df_sem=sem,
                      particle_s=time.perf_counter() - t0)
        print(f"EXACT particle-level dF = {mean:.4f} +- {sem:.4f}")
    if args.spread_seeds:
        dfs, sectors = [], []
        for seed in range(args.spread_seeds):
            dfs.append(exact_delta_f(args.samples, seed, device))
            sectors.append(exact_sector_probs(args.samples // 2, seed,
                                              device))
        result["spread"] = {
            "seeds": args.spread_seeds, "delta_f": dfs,
            "delta_f_mean": float(np.mean(dfs)),
            "delta_f_sd": float(np.std(dfs, ddof=1)),
            "sector_mean": {k: float(np.mean([p[k] for p in sectors]))
                            for k in SECTORS},
            "sector_sd": {k: float(np.std([p[k] for p in sectors], ddof=1))
                          for k in SECTORS}}
    print(json.dumps(result))
    write_evidence(args.evidence, result)
    return result


if __name__ == "__main__":
    main()
