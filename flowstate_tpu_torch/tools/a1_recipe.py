"""Algorithm 1's full recipe on the card, held to the exact ΔF.

RESULTS.md's headline run: 64 chains, 102,400 training samples, the K=15
circular-spline flow (hidden 256, 32 bins), batch 512, 40 epochs, then
1000 rounds of 150 local moves and one big move per chain.  Prints one
JSON line: the card's name and power limit, ΔF with its SEM, the
equilibrium-window ΔF, the particle-level ΔF, the big-move acceptance,
the final loss, each phase's wall time, and whether ΔF lies within 2 SEM
of the exact 1.490 (partition-function quadrature,
``tools/exact_free_energy.py`` of the repository).

    python -m flowstate_tpu_torch.tools.a1_recipe [--epochs 40] \\
        [--output_dir results] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from flowstate_tpu_torch.experiments import algorithm1
from flowstate_tpu_torch.tools.common import card
from flowstate_tpu_torch.utils.config import algorithm1_config

EXACT_DELTA_F = 1.490


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--experiment_id", type=str, default="a1_recipe")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    config = algorithm1_config(
        experiment_id=args.experiment_id, output_dir=args.output_dir,
        num_chains=64, epochs=args.epochs, big_move_interval=150,
        big_move_attempts=1000)
    t0 = time.perf_counter()
    res = algorithm1.run(config, device=args.device)
    wall_s = time.perf_counter() - t0
    df, sem = res["delta_f_mean"], res["delta_f_sem"]
    print(json.dumps({
        "card": card(args.device),
        "chains": config.num_chains, "epochs": config.epochs,
        "rounds": config.big_move_attempts,
        "samples": config.initial_training_num_samples,
        "delta_f": df, "delta_f_sem": sem,
        "delta_f_eq": res["delta_f_eq_mean"],
        "delta_f_eq_sem": res["delta_f_eq_sem"],
        "df_particle": res["df_particle"],
        "big_move_acceptance": float(res["big_move_acceptance"]),
        "final_loss": res["final_loss"], "phase_s": res["phase_s"],
        "wall_s": wall_s, "exact_delta_f": EXACT_DELTA_F,
        "within_2_sem": abs(df - EXACT_DELTA_F) <= 2 * sem,
    }), flush=True)


if __name__ == "__main__":
    main()
