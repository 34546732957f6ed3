"""Well-sector occupancy of an Algorithm 2 run against exact quadrature.

Port of ``tools/sector_check.py``.  Reads the ``production_positions.npy``
(C, T, N, 2) an Algorithm 2 run saves, drops a burn-in fraction, labels
every configuration {AAA, AAB, ABB, BBB, outside} and compares the
in-well sector fractions and the pure-sector ΔF = ln(P_BBB / P_AAA) with
the per-sector quadrature (``tools.exact_free_energy``; the pair-energy
kernel on the card).  Errors: a time-block bootstrap whose blocks span all
chains at once (the chains share one adaptively trained flow), 400
resamples of ``--block``-sample blocks, as the JAX tool.

``tools.a2_recipe`` takes its labels and bootstrap from here.  The gate
is the JAX tool's: ΔF within 3 bootstrap errors and every sector
within 0.03 absolute.  It prints SECTORS.md's table and one JSON line
with the JAX tool's keys and the card's name and power limit; it never
writes SECTORS.md.

    python -m flowstate_tpu_torch.tools.sector_check RUN/production_positions.npy
        [--burn 0.5] [--quad_samples 2000000] [--block 50] [--device cuda]
        [--seed 0] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from flowstate_tpu_torch.analysis.wells import classify_particles
from flowstate_tpu_torch.tools.common import (
    add_common_args, card, tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.exact_free_energy import exact_sector_probs

SECTORS = ["AAA", "AAB", "ABB", "BBB"]


def sector_labels(positions: np.ndarray, half_box: float,
                  r0: float = 1.2) -> np.ndarray:
    """(C, T, N, 2) -> (C, T): the number of particles in well B for a
    configuration with every particle in a well, N + 1 for one with a
    particle outside both (4 at N = 3, as the JAX tool labels it)."""
    lab = classify_particles(positions, half_box, r0)   # (C, T, N)
    n_b = (lab == 1).sum(axis=-1)
    return np.where((lab == 2).any(axis=-1), positions.shape[2] + 1, n_b)


def _stats(sec: np.ndarray) -> np.ndarray:
    """The four in-well sector weights, the outside share and the
    pure-sector ΔF of a label array."""
    counts = np.array([(sec == k).sum() for k in range(5)], dtype=float)
    in_well = counts[:4] / max(counts[:4].sum(), 1.0)
    outside = counts[4] / max(counts.sum(), 1.0)
    d_f = np.log(max(counts[3], 1.0) / max(counts[0], 1.0))
    return np.concatenate([in_well, [outside, d_f]])


def block_bootstrap(sec: np.ndarray, block: int, resamples: int = 400,
                    seed: int = 0):
    """(value, error) of ``_stats`` of a (C, T) label array, the error
    the spread over ``resamples`` time-block bootstraps whose
    ``block``-sample blocks span all chains at once."""
    t = sec.shape[1]
    blocks = np.array_split(np.arange(t), max(t // block, 1))
    rng = np.random.default_rng(seed)
    boot = np.array([_stats(sec[:, np.concatenate(
        [blocks[i] for i in rng.integers(0, len(blocks), len(blocks))])])
        for _ in range(resamples)])
    return _stats(sec), np.std(boot, axis=0, ddof=1)


def table(value, err, exact: dict, sector_dev, sigma: float,
          df_exact: float, ok: bool) -> str:
    """SECTORS.md's table and verdict lines."""
    lines = ["| sector | measured | exact | abs. deviation |",
             "|---|---|---|---|"]
    for i, s in enumerate(SECTORS):
        lines.append(f"| {s} | {value[i]:.4f} ± {err[i]:.4f} | "
                     f"{exact[s]:.4f} | {sector_dev[i]:.4f} |")
    lines.append(f"| any particle outside | {value[4]:.4f} | ~0 "
                 "(transit states) | — |")
    lines += ["", f"Pure-sector ΔF = ln(P_BBB/P_AAA) = {value[5]:.3f} ± "
              f"{err[5]:.3f} vs exact {df_exact:.4f} ({sigma:.1f} sigma).",
              f"Overall: {'PASS' if ok else 'CHECK'} (ΔF < 3 sigma; every "
              "sector < 0.03 absolute)."]
    return "\n".join(lines)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("positions", help="production_positions.npy path")
    parser.add_argument("--burn", type=float, default=0.5,
                        help="fraction of the trajectory to discard")
    parser.add_argument("--half_box", type=float, default=5.0)
    parser.add_argument("--quad_samples", type=int, default=2_000_000)
    parser.add_argument("--block", type=int, default=50,
                        help="bootstrap block length (time samples)")
    add_common_args(parser, "sector_check")
    args = parser.parse_args(argv)
    device = tool_device(args.device)

    pos = np.load(args.positions)            # (C, T, N, 2)
    c, t = pos.shape[:2]
    burn = int(t * args.burn)
    sec = sector_labels(pos[:, burn:], args.half_box)
    value, err = block_bootstrap(sec, args.block, seed=args.seed)

    exact = exact_sector_probs(args.quad_samples, args.seed, device)
    df_exact = float(exact["dF_pure"])
    sigma = abs(value[5] - df_exact) / max(err[5], 1e-12)
    sector_dev = [float(abs(value[i] - exact[s]))
                  for i, s in enumerate(SECTORS)]
    sector_sigmas = [dev / max(err[i], 1e-12)
                     for i, dev in enumerate(sector_dev)]
    # the JAX tool's gate: the ratio statistical, the weights at 3%
    # absolute (Algorithm 2's never-diminishing adaptation leaves a small
    # stationary bias in the sector weights)
    ok = sigma < 3.0 and max(sector_dev) < 0.03

    result = {
        "metric": "a2_sector_check",
        "run": args.positions,
        "samples_used": int(sec.size),
        "sector_fracs": {s: round(float(value[i]), 4)
                         for i, s in enumerate(SECTORS)},
        "sector_fracs_exact": {s: round(float(exact[s]), 4)
                               for s in SECTORS},
        "sector_sigmas": [round(float(s), 2) for s in sector_sigmas],
        "sector_abs_dev": [round(d, 4) for d in sector_dev],
        "outside_frac": round(float(value[4]), 4),
        "dF_pure": round(float(value[5]), 4),
        "dF_pure_err": round(float(err[5]), 4),
        "dF_exact": round(df_exact, 4),
        "dF_sigma": round(float(sigma), 2),
        "ok": bool(ok),
        "card": card(device),
        "chains": c, "post_burn_samples": int(sec.shape[1]),
    }
    print(table(value, err, exact, sector_dev, sigma, df_exact, ok))
    print(json.dumps(result))
    write_evidence(args.evidence, result)
    return result


if __name__ == "__main__":
    main()
