"""Weak scaling over ranks: the Metropolis engine on the chains axis and
the data-parallel training step on the batch axis.

Port of ``tools/scaling_check.py``.  The work per rank is held fixed and
the ranks are swept: each world size is one ``parallel.run_ranks`` run,
one process a rank, in which every rank

* runs ``MOVES`` moves of its ``CHAINS_PER_RANK`` chains of the
  reference system (N=3), its shard of the run cut by
  ``shard_chain_state``: K1 on the card, the plain engine on the CPU;
* takes ``STEPS`` steps of ``make_data_parallel_train_step`` on its
  ``BATCH_PER_RANK`` rows of the global batch, with a flow of K=4,
  hidden 64, 8 bins (one all-reduce of the gradients a step).

Each rank's calls are timed by ``common.steady_rate`` after the ranks
meet at a barrier.

Throughput is the world's work over its slowest rank's seconds, and the
efficiency throughput(N) / (N x throughput(1)).  On the CPU the ranks
talk over gloo, as the JAX tool's virtual CPU mesh; on the card over
NCCL, which takes one rank a card: a world size with more ranks than
visible cards is not run, and the JSON says so.  It writes no
``SCALING.md``: the table, one JSON line, and ``--evidence``'s file.

    python -m flowstate_tpu_torch.tools.scaling_check --device cpu
    python -m flowstate_tpu_torch.tools.scaling_check --world_sizes 1
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
from flowstate_tpu_torch.mcmc.state import init_chain_state
from flowstate_tpu_torch.parallel import launch
from flowstate_tpu_torch.parallel.mesh import (
    ChainMesh, make_data_parallel_train_step, replicate, shard_batch,
    shard_chain_state,
)
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.training import TrainConfig, make_optimizer

# the JAX tool's defaults (tools/scaling_check.py): chains a rank and
# moves a call of the engine, rows a rank and steps of the training flow
CHAINS_PER_RANK = 512
MOVES = 200
BATCH_PER_RANK = 128
STEPS = 5
FLOW = dict(K=4, hidden_units=64, num_bins=8)
HALF_BOX = 5.0
TIMED_CALLS = 3          # timed engine calls after a warm one


def seconds_per_call(fn, mesh: ChainMesh, calls: int) -> float:
    """Seconds per call of ``fn()`` on this rank: the ranks meet at a
    barrier, then ``common.steady_rate`` times ``calls`` calls after a
    warm one."""
    dist.barrier()
    return 1.0 / common.steady_rate(fn, mesh.device, calls)[0]


def mcmc_rank(mesh: ChainMesh, chains_per_rank: int, moves: int,
              seed: int) -> dict:
    """This rank's shard of ``world x chains_per_rank`` chains moved
    ``moves`` times a call: seconds per call and K1's launches over the
    warm call and the timed ones."""
    spec = common.double_well_spec(3)
    pos, _ = init_alternating_wells(mesh.world_size * chains_per_rank, 3,
                                    0.03)
    state = shard_chain_state(
        init_chain_state(spec, torch.as_tensor(pos), seed, 0.65), mesh)
    on_card = mesh.device.type == "cuda"
    engine = cm.run_moves_kernel if on_card else cm.run_moves_plain
    carry = {"state": state}
    before = cm.LAUNCHES

    def call():
        carry["state"] = engine(spec, 1.0, carry["state"], moves)

    seconds = seconds_per_call(call, mesh, TIMED_CALLS)
    return {"seconds": seconds, "k1_launches": cm.LAUNCHES - before}


def training_rank(mesh: ChainMesh, batch_per_rank: int, steps: int,
                  seed: int) -> dict:
    """``steps`` data-parallel steps on this rank's rows of a global
    batch of ``world x batch_per_rank``: seconds per step and the loss."""
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    model = replicate(build_circular_flow(3, 2, HALF_BOX, generator=g,
                                          device=mesh.device, **FLOW), mesh)
    config = TrainConfig(batch_size=mesh.world_size * batch_per_rank,
                         epochs=1, lr=1e-4)
    optimizer = make_optimizer(config)
    step = make_data_parallel_train_step(model, config, optimizer, mesh)
    gb = torch.Generator().manual_seed(seed + 1)
    batch = shard_batch((torch.rand(config.batch_size, 6, generator=gb)
                         * 2 - 1) * HALF_BOX, mesh)
    carry = {"opt": optimizer.init(list(model.parameters()))}

    def call():
        carry["opt"], carry["loss"] = step(carry["opt"], batch)

    seconds = seconds_per_call(call, mesh, steps)
    return {"seconds": seconds, "loss": float(carry["loss"])}


def efficiencies(rows: list, key: str) -> None:
    """throughput(N) / (N x throughput(1)), where world size 1 ran."""
    base = next((r[key] for r in rows if r["devices"] == 1), None)
    for r in rows:
        r["efficiency"] = (None if base is None
                           else r[key] / (r["devices"] * base))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world_sizes", type=int, nargs="+",
                    default=[1, 2, 4, 8])
    common.add_common_args(ap, "scaling_check")
    args = ap.parse_args(argv)
    device = common.tool_device(args.device)
    on_card = device.type == "cuda"

    cards = torch.cuda.device_count() if on_card else None
    not_run = {str(n): f"{n} NCCL ranks need {n} cards (one rank a card); "
                       f"{cards} visible"
               for n in args.world_sizes if on_card and n > cards}
    result = {"device": common.card(device),
              "backend": "nccl" if on_card else "gloo",
              "engine": ("K1 (csrc/metropolis_moves.cu)" if on_card
                         else "the plain engine"),
              "chains_per_rank": CHAINS_PER_RANK, "moves": MOVES,
              "batch_per_rank": BATCH_PER_RANK, "steps": STEPS,
              "flow": dict(FLOW), "not_run": not_run,
              "mcmc": [], "training": []}
    for n in args.world_sizes:
        if str(n) in not_run:
            continue
        ranks = launch.run_ranks(
            [(mcmc_rank, (CHAINS_PER_RANK, MOVES, args.seed)),
             (training_rank, (BATCH_PER_RANK, STEPS, args.seed))], n,
            device=device.type)
        mc = [r[0] for r in ranks]
        tr = [r[1] for r in ranks]
        chains = n * CHAINS_PER_RANK
        result["mcmc"].append({
            "devices": n, "chains": chains,
            "moves_per_s": chains * MOVES
            / max(r["seconds"] for r in mc),
            "k1_launches": sum(r["k1_launches"] for r in mc)})
        result["training"].append({
            "devices": n, "global_batch": n * BATCH_PER_RANK,
            "samples_per_s": n * BATCH_PER_RANK
            / max(r["seconds"] for r in tr),
            "loss": tr[0]["loss"]})
    efficiencies(result["mcmc"], "moves_per_s")
    efficiencies(result["training"], "samples_per_s")

    print(f"{result['device']}, {result['backend']}: Metropolis engine "
          f"(chains axis)\n| devices | chains | moves/s | efficiency |\n"
          "|---|---|---|---|")
    for r in result["mcmc"]:
        print(f"| {r['devices']} | {r['chains']} | {r['moves_per_s']:.6g} "
              f"| {r['efficiency']} |")
    print("Data-parallel flow training (batch axis, all-reduced grads)\n"
          "| devices | global batch | samples/s | efficiency |\n|---|---|---|---|")
    for r in result["training"]:
        print(f"| {r['devices']} | {r['global_batch']} "
              f"| {r['samples_per_s']:.6g} | {r['efficiency']} |")
    for n, why in not_run.items():
        print(f"world size {n} not run: {why}")
    common.write_evidence(args.evidence, result)
    print(json.dumps(common.finite_or_none(result)), flush=True)
    return result


if __name__ == "__main__":
    main()
