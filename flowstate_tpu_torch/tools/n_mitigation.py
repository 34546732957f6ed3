"""Mitigating the N > 3 big-move acceptance collapse: a measured ladder.

Port of ``tools/n_mitigation.py``.  ``hybrid_n_scaling`` measures the
wall: at Algorithm 1's budget (K=15, hidden 256, 40 epochs) the flow's
independence proposals fall from 9.5% acceptance at N=3 to 7e-4 at N=8.
This tool runs the ladder of fixes one axis at a time on fixed data
(``RUNGS``):

  base        K=15 h=256 residual net, 40 epochs (the wall's row)
  epochs      the same flow, 200 epochs          (under-training?)
  deeper      K=23, 200 epochs                   (expressiveness?)
  data4x      4x the local data, 200 epochs      (data volume?)
  transformer / gnn conditioners                 (particle symmetry?)

Each rung records the acceptance and the moments of the MH log-ratio
log r = -beta dU + log q(old) - log q(new) over every proposal: a mean
far below 0 with a large spread is q underfitting pi.  The local moves
(equilibration, collection) run on the move kernel and every proposal's
energy on the pair-energy kernel.  The transformer rung's acceptance is
``split_acceptance``: the same estimator with the Metropolis arithmetic
on the host, as JAX measures it.  A rung that raises is recorded as a
row with ``error``.  ``--evidence`` merges this run's rows into the file's
same-N system, as the JAX tool merges into its JSON; it never writes the
JAX tool's file.

    python -m flowstate_tpu_torch.tools.n_mitigation [--n 8]
        [--rungs base,epochs,deeper,data4x,transformer,gnn]
        [--device cuda] [--seed 0] [--evidence [PATH]]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves, to_centered
from flowstate_tpu_torch.mcmc.state import batched_energy_virial
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.tools.common import (
    HostLoopTimer, add_common_args, card, double_well_spec,
    tool_device, write_evidence,
)
from flowstate_tpu_torch.tools.ess_check import equilibrated_state
from flowstate_tpu_torch.training import TrainConfig, train

RUNGS = {
    "base": dict(K=15, hidden=256, epochs=40, net="residual", data=1),
    "epochs": dict(K=15, hidden=256, epochs=200, net="residual", data=1),
    "deeper": dict(K=23, hidden=256, epochs=200, net="residual", data=1),
    "data4x": dict(K=15, hidden=256, epochs=200, net="residual", data=4),
    # split=True: the acceptance by split_acceptance, as in JAX (whose
    # fused big-move program with the transformer did not compile)
    "transformer": dict(K=15, hidden=256, epochs=100, net="transformer",
                        data=1, split=True),
    "gnn": dict(K=15, hidden=64, epochs=100, net="gnn", data=1),
}


def split_acceptance(spec, beta, model, half_box, state0, acc_rounds,
                     seed: int = 0):
    """Big-move acceptance with the Metropolis arithmetic on the host:
    per round, the flow's proposals and their log q (a generator seeded
    ``seed + 1000 + round``), the current points' log q, the proposals'
    energies (the pair-energy kernel on the card), then the ratio, the
    uniforms of numpy's ``default_rng(7)`` and the state update in numpy.
    The same estimator as ``nf_big_moves``'s rounds.  Returns the (rounds,
    C) accept flags (float32) and log-ratios."""
    c, n = state0.positions.shape[:2]
    device = state0.device
    positions = state0.positions.cpu().numpy()
    energy = state0.energy.cpu().numpy()
    rng = np.random.default_rng(7)
    accs, rlogs = [], []
    with torch.no_grad():
        for rd in range(acc_rounds):
            g = torch.Generator(device=device).manual_seed(seed + 1000 + rd)
            prop_flat, log_q_new = model.sample_and_log_prob(c, g)
            proposals = prop_flat.cpu().numpy().reshape(c, n, 2) + half_box
            log_q_old = model.log_prob(torch.as_tensor(
                (positions - half_box).reshape(c, -1),
                device=device)).cpu().numpy()
            enn = batched_energy_virial(spec, torch.as_tensor(
                proposals, device=device))[0].cpu().numpy()
            ratio_log = -beta * (enn - energy) + (
                log_q_old - log_q_new.cpu().numpy())
            u = rng.uniform(size=c)
            accept = u < np.exp(np.minimum(ratio_log, 0.0))
            positions = np.where(accept[:, None, None], proposals, positions)
            energy = np.where(accept, enn, energy)
            accs.append(accept.astype(np.float32))
            rlogs.append(ratio_log)
    return np.stack(accs), np.stack(rlogs)


def merge(path, out: dict) -> dict:
    """This run's system ``out`` merged into the document at ``path``: its
    rows replace the same rungs' rows of the same N, and the system goes
    last."""
    n = out["n"]
    if path and os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        systems = prev.get("systems", [prev] if "rows" in prev else [])
        mine = [s for s in systems if s.get("n") == n]
        if mine:
            kept = [r for r in mine[0]["rows"]
                    if r.get("rung") not in {q.get("rung")
                                             for q in out["rows"]}]
            out["rows"] = kept + out["rows"]
        systems = [s for s in systems if s.get("n") != n] + [out]
        return {"metric": "n_mitigation", "systems": systems}
    return {"metric": "n_mitigation", "systems": [out]}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--collect_rounds", type=int, default=100)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--acc_rounds", type=int, default=200)
    ap.add_argument("--rungs",
                    default="base,epochs,deeper,data4x,transformer,gnn")
    add_common_args(ap, "n_mitigation")
    return ap


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    device = tool_device(args.device)
    n, c = args.n, args.chains
    spec = double_well_spec(n)
    beta = 1.0
    half_box = spec.box.size_x / 2

    state0 = equilibrated_state(spec, c, args.seed + n, device,
                                common.SPLIT_EQUILIBRATION_MOVES)
    print(f"N={n}: equilibrated {c} chains", flush=True)

    def collect(rounds):
        st, configs = state0, []
        for _ in range(rounds):
            st = run_moves_auto(spec, beta, st, args.moves_per_round)
            configs.append(st.positions)
        return to_centered(torch.stack(configs).reshape(-1, n, 2), half_box)

    data1x = collect(args.collect_rounds)
    print(f"N={n}: {data1x.shape[0]} local configs (1x)", flush=True)

    data4x = None
    rows = []
    for rung in args.rungs.split(","):
        r = RUNGS[rung]
        if r["data"] == 4:
            if data4x is None:
                data4x = torch.cat([data1x,
                                    collect(3 * args.collect_rounds)])
                print(f"N={n}: {data4x.shape[0]} local configs (4x)",
                      flush=True)
            data = data4x
        else:
            data = data1x
        tcfg = TrainConfig(batch_size=512, epochs=r["epochs"], lr=1e-4)
        try:
            model = build_circular_flow(
                n, 2, half_box, K=r["K"], hidden_units=r["hidden"],
                num_bins=32, num_blocks=2, net_type=r["net"], device=device,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed + 1))
            with HostLoopTimer(device) as timer:
                _, _, _, loss_epoch = train(
                    model, data, tcfg,
                    torch.Generator(device=device).manual_seed(args.seed + 2))
            dt_train = timer.seconds

            if r.get("split"):
                acc, rlog = split_acceptance(spec, beta, model, half_box,
                                             state0, args.acc_rounds,
                                             args.seed)
            else:
                g = torch.Generator(device=device).manual_seed(args.seed + 3)
                st, acc, rlog = state0, [], []
                for _ in range(args.acc_rounds):
                    res = nf_big_moves(spec, beta, st, model, half_box, g)
                    st = res.state
                    acc.append(res.accepted.float())
                    rlog.append(res.ratio_log)
                acc = torch.stack(acc).cpu().numpy()
                rlog = torch.stack(rlog).cpu().numpy()
        except Exception as e:
            # record, don't die: the other rungs still run
            print(f"{rung}: FAILED {e!r}"[:400], flush=True)
            rows.append({"rung": rung, "error": repr(e)[:300]})
            continue
        rlog = np.asarray(rlog).ravel()
        finite = rlog[np.isfinite(rlog)]
        row = {
            "rung": rung, **{k: r[k] for k in ("K", "hidden", "epochs",
                                               "net")},
            "train_configs": int(data.shape[0]),
            "train_wall_s": round(dt_train, 1),
            "fkld_first": round(float(loss_epoch[0]), 3),
            "fkld_last": round(float(loss_epoch[-1]), 3),
            "proposals": int(acc.size),
            "acceptance": round(float(acc.mean()), 6),
            # log-ratio moments: mean << 0, large std = q underfits pi
            "ratio_log_mean": round(float(finite.mean()), 2),
            "ratio_log_std": round(float(finite.std()), 2),
            "ratio_log_p99": round(float(np.percentile(finite, 99)), 2),
            "ratio_log_frac_inf": round(
                float(1.0 - finite.size / rlog.size), 4),
        }
        rows.append(row)
        print(row, flush=True)

    out = merge(args.evidence, {"metric": "n_mitigation", "n": n,
                                "chains": c, "device": card(device),
                                "seed": args.seed, "rows": rows})
    write_evidence(args.evidence, out)
    print(json.dumps({"metric": "n_mitigation", "n": n,
                      "rungs": [r.get("rung") for r in rows]}))
    return out


if __name__ == "__main__":
    main()
