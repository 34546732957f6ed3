"""Algorithm 2's full recipe on the card, held to the exact sector weights.

SECTORS.md's headline run: the reference's full-scale Algorithm 2 (100
chains, 1000 cycles, the K=23 circular-spline flow with hidden 128 and 15
bins, batch 256, 1 epoch a cycle, 10 samples per chain a cycle) with the
flow frozen after cycle 500.  Prints one JSON line and writes it to
``--evidence``: the card's name and power limit; the big-move acceptance
at cycles 100, 300, 500 and 1000; the naive ΔF with its SEM; over the
last 45% of each chain, the weights of the sectors AAA / AAB / ABB / BBB
(by the number of particles in well B, among configurations with every
particle in a well) and the share with a particle outside both wells,
each with a time-block bootstrap error (blocks of 50 samples, and of
500 beside them), and the pure-sector ΔF = ln(P_BBB / P_AAA) with its
error; each weight against the exact one, and ms per cycle by phase.

The exact weights are the per-sector quadrature of
``tools/exact_free_energy.py`` (2,000,000 points per sector), as
SECTORS.md:17-22 gives them.  The labelling and the bootstrap are those of
``tools/sector_check.py``: the blocks span all chains at once, since the
chains share one flow.

    python -m flowstate_tpu_torch.tools.a2_recipe [--cycles 1000] \\
        [--freeze_after 500] [--fused] [--master_seed 42] \\
        [--output_dir results] \\
        [--evidence results/evidence/a2_recipe_torch_data.json] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from flowstate_tpu_torch.experiments import algorithm2
from flowstate_tpu_torch.tools.common import card
from flowstate_tpu_torch.tools.sector_check import (
    block_bootstrap, sector_labels,
)
from flowstate_tpu_torch.utils.config import algorithm2_config

SECTORS = ("AAA", "AAB", "ABB", "BBB")
# per-sector quadrature, SECTORS.md:17-22
EXACT_WEIGHTS = {"AAA": 0.0378, "AAB": 0.3011, "ABB": 0.4939, "BBB": 0.1672}
EXACT_DELTA_F_PURE = 1.4859
BURN = 0.55            # the window: the last 45% of each chain
BLOCK = 50             # bootstrap block length, in samples
LONG_BLOCK = 500       # a longer block: errors if correlations outlast 50
BOOTSTRAP = 400        # resamples
ACCEPTANCE_AT = (100, 300, 500, 1000)


def sector_weights(sec: np.ndarray, block: int = BLOCK,
                   resamples: int = BOOTSTRAP, seed: int = 0) -> dict:
    """Weights of the sectors of 3 particles (in-well configurations
    only), the outside share and the pure-sector ΔF of a (C, T) label
    array, each with the spread of a time-block bootstrap over all chains
    jointly."""
    value, err = block_bootstrap(sec, block, resamples, seed)
    out = {"samples": int(sec.size)}
    for i, name in enumerate(SECTORS):
        out[name] = {"weight": float(value[i]), "err": float(err[i]),
                     "exact": EXACT_WEIGHTS[name],
                     "sigmas": float(abs(value[i] - EXACT_WEIGHTS[name])
                                     / max(err[i], 1e-12))}
    out["outside"] = {"weight": float(value[4]), "err": float(err[4])}
    out["delta_f_pure"] = {
        "value": float(value[5]), "err": float(err[5]),
        "exact": EXACT_DELTA_F_PURE,
        "sigmas": float(abs(value[5] - EXACT_DELTA_F_PURE)
                        / max(err[5], 1e-12))}
    out["sectors_within_3_err"] = all(out[n]["sigmas"] <= 3.0
                                      for n in SECTORS)
    out["delta_f_within_2_err"] = out["delta_f_pure"]["sigmas"] <= 2.0
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cycles", type=int, default=1000)
    parser.add_argument("--freeze_after", type=int, default=500)
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--experiment_id", type=str, default="a2_recipe")
    parser.add_argument("--master_seed", type=int, default=42)
    parser.add_argument("--evidence", type=str,
                        default="results/evidence/a2_recipe_torch_data.json")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    config = algorithm2_config(experiment_id=args.experiment_id,
                               output_dir=args.output_dir,
                               num_training_cycles=args.cycles,
                               master_seed=args.master_seed)
    t0 = time.perf_counter()
    res = algorithm2.run(config, fused=args.fused,
                         freeze_after=args.freeze_after, device=args.device)
    wall_s = time.perf_counter() - t0
    positions = np.load(os.path.join(res["directory"],
                                     "production_positions.npy"))
    window = positions[:, int(positions.shape[1] * BURN):]
    labels = sector_labels(window, config.half_box, config.r0)
    sectors = sector_weights(labels)
    long = sector_weights(labels, LONG_BLOCK)
    ph, n = res["phase_s"], res["cycles_run"]
    trained = min(n, args.freeze_after) if args.freeze_after else n
    p_acc = res["p_acc_history"]
    doc = {
        "card": card(args.device),
        "chains": config.num_chains, "cycles": n, "K": config.K,
        "master_seed": config.master_seed,
        "hidden_units": config.hidden_units, "num_bins": config.num_bins,
        "batch_size": config.batch_size, "epochs": config.epochs,
        "freeze_after": args.freeze_after, "fused": args.fused,
        "acceptance_at": {str(c): p_acc[c] for c in ACCEPTANCE_AT
                          if c < len(p_acc)},
        "big_move_acceptance": float(res["big_move_acceptance"]),
        "delta_f": res["delta_f_mean"], "delta_f_sem": res["delta_f_sem"],
        "window_samples_per_chain": int(window.shape[1]),
        "sectors": sectors,
        "errors_block_500": {k: long[k]["err"] for k in (
            *SECTORS, "outside", "delta_f_pure")},
        "final_loss": (res["loss_per_cycle"][-1]
                       if res["loss_per_cycle"] else None),
        "ms_per_cycle": {k: 1e3 * ph[k] / n for k in (
            "production", "training", "big_move", "evaluation",
            "fused_cycles")},
        "training_ms_per_trained_cycle": 1e3 * ph["training"] / max(
            trained, 1),
        "phase_s": ph, "wall_s": wall_s,
    }
    line = json.dumps(doc)
    os.makedirs(os.path.dirname(os.path.abspath(args.evidence)),
                exist_ok=True)
    with open(args.evidence, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return doc


if __name__ == "__main__":
    main()
