"""Algorithm 2 with the mixed loss (alpha < 1), driven for real.

Port of ``tools/alpha_study.py``.  The reverse-KLD (energy) term of the
loss ``alpha * forward_kld + (1 - alpha) * reverse_kld`` is dead weight at
the reference's alpha = 1.  This tool runs the same A2 schedule
(``algorithm2_config``: 100 chains, K=23, hidden 128) at each alpha of
``--alphas``, with the same seed and budget, and records what the energy
term buys and costs: the big-move acceptance a cycle, the final ΔF and
the wall.  ``--lr_list`` runs every (alpha, lr) pair and, with
``--evidence`` naming an existing file, appends them under
``lr_sweep_runs`` instead of replacing the study.  A2 runs on its host
loop (the fused cycles refuse alpha < 1, as in JAX): the local moves on
the move kernel, every energy on the pair-energy kernel.  Each run's
directory and evidence go under ``--output_dir``; the study's JSON only
to ``--evidence``, never to the JAX tool's file or RESULTS.md.

    python -m flowstate_tpu_torch.tools.alpha_study [--cycles 150]
        [--alphas 1.0,0.5] [--lr_list 1e-4,5e-4] [--output_dir DIR]
        [--device cuda] [--seed 42] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json
import os

from flowstate_tpu_torch.experiments import algorithm2
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, tool_device, write_evidence,
)
from flowstate_tpu_torch.utils.config import algorithm2_config


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=150)
    ap.add_argument("--chains", type=int, default=100)
    ap.add_argument("--alphas", default="1.0,0.5")
    ap.add_argument("--lr_list", default=None,
                    help="comma list of learning rates: runs every "
                         "(alpha, lr) pair and stores them under "
                         "'lr_sweep_runs'")
    ap.add_argument("--output_dir", default="results/alpha_study")
    # the A2 preset's master seed
    add_common_args(ap, "alpha_study", seed=42)
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = tool_device(args.device)
    lrs = ([float(x) for x in args.lr_list.split(",")]
           if args.lr_list else [None])
    runs = []
    for alpha in [float(a) for a in args.alphas.split(",")]:
        for lr in lrs:
            tag = (f"a2_alpha_{alpha:g}" if lr is None
                   else f"a2_alpha_{alpha:g}_lr_{lr:g}")
            lr_kw = {} if lr is None else {"lr": lr}
            cfg = algorithm2_config(
                experiment_id=tag, output_dir=args.output_dir,
                num_chains=args.chains, num_training_cycles=args.cycles,
                checkpoint_interval=max(25, args.cycles // 4),
                alpha=alpha, master_seed=args.seed, **lr_kw)
            with HostLoopTimer(device) as timer:
                res = algorithm2.run(cfg, device=device)
            wall = timer.seconds
            ev_path = os.path.join(args.output_dir, "evidence",
                                   f"{tag}_data.json")
            with open(ev_path) as f:
                ev = json.load(f)
            runs.append({
                "alpha": alpha, "lr": lr if lr is not None else cfg.lr,
                "wall_s": round(wall, 1),
                "cycles": args.cycles, "chains": args.chains,
                "big_move_acceptance_final": res["big_move_acceptance"],
                "delta_f_mean": res.get("delta_f_mean"),
                "delta_f_sem": res.get("delta_f_sem"),
                "p_acc_history": ev["p_acc_history"],
                "loss_per_cycle": ev["loss_per_cycle"],
                "sector_counts": ev.get("sector_counts"),
                "phase_s": res["phase_s"],
            })
            print(f"alpha={alpha} lr={runs[-1]['lr']:g}: "
                  f"p_acc={res['big_move_acceptance']:.4f} "
                  f"dF={res.get('delta_f_mean')} wall={wall:.1f}s",
                  flush=True)

    if args.lr_list and args.evidence and os.path.exists(args.evidence):
        # the lr sweep appends to the existing study instead of replacing
        # the full-budget alpha comparison
        with open(args.evidence) as f:
            out = json.load(f)
        out["lr_sweep_runs"] = out.get("lr_sweep_runs", []) + runs
    else:
        out = {"metric": "alpha_study", "device": card(device),
               "seed": args.seed, "runs": runs}
    write_evidence(args.evidence, out)
    print(json.dumps({"metric": "alpha_study",
                      "alphas": [r["alpha"] for r in runs],
                      "p_acc": [r["big_move_acceptance_final"]
                                for r in runs],
                      "wall_s": [r["wall_s"] for r in runs]}))
    return out


if __name__ == "__main__":
    main()
