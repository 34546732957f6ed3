"""Statistics of the move kernel on the card against the plain engine.

Port of ``tools/pallas_check.py`` (PALLAS.md's checks): the move kernel K1
(``mcmc/cuda_metropolis.py::run_moves_kernel``, ``--fast_math`` for its
fast-math variant) against the plain engine (``run_moves_plain``, the
kernel's PyTorch version, here on the same device) on one budget:

  1. acceptance of both engines, within 0.02;
  2. the kernel's tracked-energy drift against a resync through the
     pair-energy kernel after its two segments, below 1e-2;
  3. per-particle well occupancy and the energy per particle of both, the
     means within 4 cross-chain standard errors;
  4. the kernel's virial poisoned (NaN) until the resync;
  5. an odd chain count (C = 1000) and N = 12 (drift below 1e-2);
  6. N = 128 pure LJ from ``initialise_fcc`` (drift per particle below
     1e-2, acceptance in (0.05, 0.95));
     both at 512 chains, or ``--chains`` if fewer;
  7. moves/s of both engines over their second segment (host clock
     around a synchronised call).

The chains are equilibrated by the kernel (5000 moves, the displacement
adapted every 500), then each engine runs two segments of ``--moves``
from that state.

It prints PALLAS.md's table and one JSON line with the JAX tool's keys:
the ``pallas`` fields hold the kernel's numbers and the ``xla`` fields
the plain engine's; beside them the card's name and power limit.  It
never writes PALLAS.md.  On the CPU both engines are the plain one.

    python -m flowstate_tpu_torch.tools.move_kernel_check [--chains 16384]
        [--moves 4096] [--fast_math] [--device cuda] [--seed 0] [--evidence]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.initialise import (
    init_alternating_wells, initialise_fcc,
)
from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
from flowstate_tpu_torch.mcmc.state import init_chain_state, resync_energy
from flowstate_tpu_torch.ops import SystemSpec
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    add_common_args, card, double_well_spec, sync, tool_device,
    write_evidence,
)

WELL_RADIUS = 1.1 * 1.2
ODD_CHAINS = 1000       # a chain count that is no multiple of a block


def occupancy(spec, positions: torch.Tensor):
    """Per-particle well-A and well-B occupancy fractions of (C, N, 2)."""
    lx, ly = spec.box.size_x, spec.box.size_y
    sizes = torch.tensor([lx, ly], dtype=positions.dtype,
                         device=positions.device)

    def frac(center):
        d = positions - torch.tensor(center, dtype=positions.dtype,
                                     device=positions.device)
        d = d - sizes * torch.round(d / sizes)
        inside = torch.sqrt(torch.sum(d * d, dim=-1)) <= WELL_RADIUS
        return int(inside.sum()) / inside.numel()

    return frac([lx / 4, ly / 2]), frac([3 * lx / 4, ly / 2])


def acceptance(after, before) -> float:
    return (int((after.accepts - before.accepts).sum())
            / int((after.attempts - before.attempts).sum()))


def max_drift(spec, state) -> float:
    return float((state.energy - resync_energy(spec, state).energy)
                 .abs().max())


def timed_segments(mover, state, moves: int, device):
    """Two segments of ``moves``; the second timed.  Returns the state
    and its moves/s."""
    s = mover(state, moves)
    sync(device)
    t0 = time.perf_counter()
    s = mover(s, moves)
    sync(device)
    return s, s.positions.shape[0] * moves / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=16384)
    parser.add_argument("--moves", type=int, default=4096)
    parser.add_argument("--fast_math", action="store_true",
                        help="check the kernel's fast-math variant")
    add_common_args(parser, "move_kernel_check")
    args = parser.parse_args(argv)
    device = tool_device(args.device)
    beta = 1.0

    def kernel(spec):
        if device.type == "cuda":
            return lambda s, m: cm.run_moves_kernel(spec, beta, s, m,
                                                    fast_math=args.fast_math)
        return lambda s, m: cm.run_moves_plain(spec, beta, s, m)

    def plain(spec):
        return lambda s, m: cm.run_moves_plain(spec, beta, s, m)

    c, m = args.chains, args.moves
    spec = double_well_spec(3)
    positions, _ = init_alternating_wells(c, 3, 0.03)
    state0 = init_chain_state(spec, torch.as_tensor(positions, device=device),
                              args.seed, 0.65)
    state0 = run_equilibration(spec, beta, state0,
                               common.EQUILIBRATION_MOVES, 500,
                               move_fn=kernel(spec))

    # 1, 2) the kernel: acceptance, drift, the poisoned virial
    s, kernel_moves_per_s = timed_segments(kernel(spec), state0, m, device)
    acc_k = acceptance(s, state0)
    virial_poisoned = bool(torch.isnan(s.virial).all())
    drift = (s.energy - resync_energy(spec, s).energy).abs()
    drift_max, drift_mean = float(drift.max()), float(drift.mean())
    occ_k = occupancy(spec, s.positions)

    # 3) the plain engine on the same budget from the same state
    x, plain_moves_per_s = timed_segments(plain(spec), state0, m, device)
    acc_p = acceptance(x, state0)
    occ_p = occupancy(spec, x.positions)
    e_k = (s.energy.double() / 3).cpu().numpy()
    e_p = (x.energy.double() / 3).cpu().numpy()
    sem = float(np.sqrt(e_k.var() / c + e_p.var() / c))
    e_sigma = abs(float(e_k.mean() - e_p.mean())) / max(sem, 1e-12)

    # 4) an odd chain count
    pos_odd, _ = init_alternating_wells(ODD_CHAINS, 3, 0.03)
    st_odd = init_chain_state(spec, torch.as_tensor(pos_odd, device=device),
                              args.seed + 1, 0.65)
    out_odd = kernel(spec)(st_odd, 256)
    pad_drift = max_drift(spec, out_odd)
    pad_ok = (tuple(out_odd.positions.shape) == (ODD_CHAINS, 3, 2)
              and pad_drift < 1e-2)

    # 5) N = 12
    spec12 = double_well_spec(12)
    side = min(512, c)
    pos12, _ = init_alternating_wells(side, 12, 0.03)
    st12 = init_chain_state(spec12, torch.as_tensor(pos12, device=device),
                            args.seed + 2, 0.65)
    out12 = kernel(spec12)(st12, 256)
    drift12 = max_drift(spec12, out12)
    acc12 = acceptance(out12, st12)

    # 6) N = 128 pure LJ, warmed by the plain engine as the JAX tool's
    nbig = 128
    pos_big, box_big = initialise_fcc(nbig, 0.3, 1.0)
    spec_big = SystemSpec.create(nbig, box_big, num_wells=0)
    st_big = init_chain_state(
        spec_big, torch.as_tensor(np.broadcast_to(
            pos_big, (side, nbig, 2)).copy(), device=device),
        args.seed + 3, 0.3)
    st_big = resync_energy(spec_big, plain(spec_big)(st_big, 512))
    out_big = kernel(spec_big)(st_big, 1024)
    # the tracked total sums some N x moves float32 changes: per particle
    drift_big = max_drift(spec_big, out_big) / nbig
    acc_big = acceptance(out_big, st_big)

    ok = bool(abs(acc_k - acc_p) < 0.02 and drift_max < 1e-2
              and e_sigma < 4.0 and virial_poisoned and pad_ok
              and drift12 < 1e-2 and drift_big < 1e-2
              and 0.05 < acc_big < 0.95)
    result = {
        "metric": "pallas_kernel_checks",
        "chains": c,
        "moves_per_chain": 2 * m,
        "acceptance_pallas": round(acc_k, 4),
        "acceptance_xla": round(acc_p, 4),
        "energy_drift_max": drift_max,
        "energy_drift_mean": drift_mean,
        "virial_poisoned": virial_poisoned,
        "occupancy_pallas": [round(occ_k[0], 4), round(occ_k[1], 4)],
        "occupancy_xla": [round(occ_p[0], 4), round(occ_p[1], 4)],
        "energy_mean_sigma_distance": round(e_sigma, 2),
        "autopad_ok": pad_ok,
        "n12_drift_max": drift12,
        "n12_acceptance": round(acc12, 4),
        "n128_drift_per_particle": drift_big,
        "n128_acceptance": round(acc_big, 4),
        "pallas_moves_per_s": round(kernel_moves_per_s, 1),
        "xla_moves_per_s": round(plain_moves_per_s, 1),
        "device": card(device),
        "ok": ok,
        "fast_math": args.fast_math,
        "energy_per_particle": [float(e_k.mean()), float(e_p.mean())],
        "odd_chains_drift": pad_drift,
    }
    verdict = lambda b: "PASS" if b else "FAIL"  # noqa: E731
    print("| check | kernel | plain engine | verdict |\n|---|---|---|---|\n"
          f"| acceptance | {acc_k:.4f} | {acc_p:.4f} | "
          f"{verdict(abs(acc_k - acc_p) < 0.02)} (< 0.02) |\n"
          f"| tracked-energy drift after {2 * m} moves (max / mean) | "
          f"{drift_max:.2e} / {drift_mean:.2e} | exact | "
          f"{verdict(drift_max < 1e-2)} (< 1e-2) |\n"
          f"| per-particle occupancy (A, B) | ({occ_k[0]:.4f}, "
          f"{occ_k[1]:.4f}) | ({occ_p[0]:.4f}, {occ_p[1]:.4f}) | — |\n"
          f"| energy/particle mean | {e_k.mean():.5f} | {e_p.mean():.5f} | "
          f"{e_sigma:.2f} sigma {verdict(e_sigma < 4)} (< 4) |\n"
          f"| virial poisoned until resync | {virial_poisoned} | — | "
          f"{verdict(virial_poisoned)} |\n"
          f"| C={ODD_CHAINS} drift | {pad_drift:.2e} | — | "
          f"{verdict(pad_ok)} |\n"
          f"| N=12 drift / acceptance | {drift12:.2e} / {acc12:.3f} | — | "
          f"{verdict(drift12 < 1e-2)} |\n"
          f"| N=128 pure LJ drift/particle / acceptance | {drift_big:.2e} / "
          f"{acc_big:.3f} | — | "
          f"{verdict(drift_big < 1e-2 and 0.05 < acc_big < 0.95)} |\n"
          f"| moves/s | {kernel_moves_per_s:,.0f} | {plain_moves_per_s:,.0f}"
          f" | — |\n\nOverall: {verdict(ok)}.")
    print(json.dumps(result))
    write_evidence(args.evidence, result)
    return result


if __name__ == "__main__":
    main()
