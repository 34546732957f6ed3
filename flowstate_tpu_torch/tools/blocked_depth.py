"""Conditional-flow depth sweep: how shallow can the blocked proposal go?

Port of ``tools/blocked_depth.py``.  A blocked move's cost is its K-deep
chain of couplings, so the depth is the direct throughput lever.  At
N=8, k=1, per K (and hidden width) of the sweep this tool trains the
conditional flow on the same PT oracle data (``blocked_wall``'s recipe,
Fourier context, 30 epochs at lr 3e-4), measures the blocked-move
acceptance, runs the hybrid (one move-kernel launch and N // k blocked
moves a round) for the well label's ESS and the particle-level ΔF
against PT's, and times the production round as the bench's blocked
segment does: ``BIG_CALLS`` calls of ``ROUNDS_PER_CALL`` blocked moves on
``BENCH_CHAINS`` chains after two untimed calls, by CUDA events
(``--skip_throughput`` leaves it out).  Every proposal's energy goes
through the pair-energy kernel.  The result has the JAX tool's keys;
``--evidence`` is written after each row.  The K=10 row is the witness to
set beside Algorithm 1's blocked acceptance.

    python -m flowstate_tpu_torch.tools.blocked_depth [--K_list 4,6,10]
        [--hidden_list 128] [--skip_throughput] [--device cuda] [--seed 0]
        [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json

import torch

from flowstate_tpu_torch.mcmc.blocked import (
    blocked_big_moves, fourier_context, fourier_context_dim,
)
from flowstate_tpu_torch.mcmc.initialise import init_split_wells
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.blocked_wall import blocked_study, pt_data
from flowstate_tpu_torch.tools.common import (
    add_common_args, card, double_well_spec, hybrid_summary,
    timed, tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import equilibrated_state

BENCH_CHAINS = 16384  # the bench's production ensemble
ROUNDS_PER_CALL = 64
BIG_CALLS = 3


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--K_list", default="4,6,10")
    ap.add_argument("--hidden_list", default="128",
                    help="comma list; crossed with K_list")
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--m_max", type=int, default=3)
    ap.add_argument("--skip_throughput", action="store_true",
                    help="CPU smoke: skip the 16,384-chain timed segment")
    add_common_args(ap, "blocked_depth")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = tool_device(args.device)
    n, k = args.n, args.k
    spec = double_well_spec(n)
    half_box = spec.box.size_x / 2
    ctx_fn = lambda r, p: fourier_context(r, p, half_box,  # noqa: E731
                                          m_max=args.m_max)
    ctx_dim = fourier_context_dim(args.m_max)

    state0 = equilibrated_state(spec, args.chains, args.seed + n, device,
                                common.SPLIT_EQUILIBRATION_MOVES)
    print(f"N={n}: equilibrated {args.chains} chains", flush=True)

    # ---- PT oracle + training data, once (blocked_wall's recipe, so
    # that rows are comparable) -------------------------------------------
    df_pt, _, data_pt = pt_data(spec, args, device)
    print(f"N={n}: PT dF={df_pt:.4f}, {int(data_pt.shape[0])} train configs",
          flush=True)

    out = {"metric": "blocked_depth", "n": n, "k": k,
           "device": card(device),
           "context": f"fourier(m_max={args.m_max})", "bins": args.bins,
           "pt": {"df_particle": round(df_pt, 4),
                  "ladder": f"{args.replicas}x{args.chains // args.replicas}"
                            f", T_hot={args.t_hot}"},
           "bench_chains": BENCH_CHAINS, "seed": args.seed, "rows": []}

    if not args.skip_throughput:
        pos_b, _ = init_split_wells(BENCH_CHAINS, n, 0.03)
        st_bench0 = init_chain_state(
            spec, torch.as_tensor(pos_b, device=device), args.seed + 22,
            0.65)

    for K in [int(x) for x in args.K_list.split(",")]:
        for hidden in [int(x) for x in args.hidden_list.split(",")]:
            loss_epoch, dt_train, acc, (w, n_a, n_b, dt), _, model = (
                blocked_study(spec, args, state0, data_pt, k, half_box,
                              ctx_fn, ctx_dim, K, hidden,
                              min(512, int(data_pt.shape[0])), device))
            row = {"K": K, "hidden": hidden,
                   "train_wall_s": round(dt_train, 1),
                   "loss_last": round(float(loss_epoch[-1]), 3),
                   "acceptance": round(acc, 5)}
            row.update(hybrid_summary(w, n_a, n_b, dt, df_pt))

            # ---- the bench's production-round segment: BENCH_CHAINS
            # chains, ROUNDS_PER_CALL blocked moves a call, two warm-ups --
            if not args.skip_throughput:
                g = torch.Generator(device=device).manual_seed(args.seed + 5)

                def blocked_rounds(s1):
                    for _ in range(ROUNDS_PER_CALL):
                        s1 = blocked_big_moves(spec, 1.0, s1, model,
                                               half_box, k, g,
                                               context_fn=ctx_fn).state
                    return s1

                sb = blocked_rounds(blocked_rounds(st_bench0))

                def calls(s1):
                    for _ in range(BIG_CALLS):
                        s1 = blocked_rounds(s1)
                    return s1

                _, dt_blk = timed(lambda: calls(sb), device)
                rps = ROUNDS_PER_CALL * BIG_CALLS / dt_blk
                row["blocked_moves_per_s"] = round(BENCH_CHAINS * rps, 1)

            print(f"K={K} h={hidden}: acc={row['acceptance']:.4f} "
                  f"dF={row['df_particle']:.4f} (PT {df_pt:.4f}) "
                  f"ESS/s={row.get('well_ess_per_s')} "
                  f"moves/s={row.get('blocked_moves_per_s')}", flush=True)
            out["rows"].append(row)
            write_evidence(args.evidence, out)

    print(json.dumps({"metric": "blocked_depth", "rows": len(out["rows"])}))
    return out


if __name__ == "__main__":
    main()
