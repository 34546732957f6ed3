"""A1's training step on the card, its gradient bytes and the modelled
data-parallel all-reduce.

Port of ``tools/dp_measure.py``.  It counts the parameters and float32
gradient bytes of Algorithm 1's full flow (K=15, hidden 256, 32 bins, 2
blocks), times ``make_train_step`` at ``--batch`` and models the ring
all-reduce of the gradients, 2 (N - 1) / N x the gradient bytes a card,
over stated links: NVLink within a host of up to 8 cards, InfiniBand
between hosts.  Only the link is modelled; the step's times and the bytes
are measured and counted.

Two times of a step: the wall time, a host clock around ``--steps`` steps
that ends in a synchronize, and the device time, the kernels' time
summed by ``torch.profiler`` over a window of as many steps (where the
profiler records nothing, no device time: CUDA events around the window
give ``events_ms_per_step`` instead).  JAX timed a scanned block of steps,
one device program; the port dispatches each step's kernels from the
host, and the two times say how far the host holds the step back.  The
weak-scaling efficiency t / (t + t_allreduce) is given against each.

It writes no ``SCALING.md``: one JSON line, and ``--evidence``'s file.

    python -m flowstate_tpu_torch.tools.dp_measure --evidence
    python -m flowstate_tpu_torch.tools.dp_measure --device cpu --batch 8 --steps 2
"""

from __future__ import annotations

import argparse
import json

import torch

from flowstate_tpu_torch.entry import A1_FLOW, A1_HALF_BOX
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.training import (
    TrainConfig, make_optimizer, make_train_step,
)

# the links assumed: NVLink 4 of an H100 SXM, 900 GB/s both ways, 450 one
# way, between the cards of one host; 400 Gb/s InfiniBand (NDR) a card
# between hosts
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9
CARDS_PER_HOST = 8
CARDS = (2, 4, 8, 16, 64, 256)


def a1_flow(device, generator: torch.Generator):
    """Algorithm 1's flow at full width (``entry.A1_FLOW``)."""
    return build_circular_flow(3, 2, A1_HALF_BOX, generator=generator,
                               device=device, **A1_FLOW)


def link(cards: int) -> tuple:
    """``(name, bytes per second one way)`` of the ring's slowest link."""
    if cards <= CARDS_PER_HOST:
        return "nvlink", NVLINK_BYTES_PER_S
    return "infiniband", IB_BYTES_PER_S


def allreduce_seconds(cards: int, grad_bytes: int) -> float:
    """The ring all-reduce: 2 (N - 1) / N x the bytes over the link."""
    return 2 * (cards - 1) / cards * grad_bytes / link(cards)[1]


def efficiency(step_s, allreduce_s: float):
    """Weak scaling: the step's share of a step plus its all-reduce."""
    return None if step_s is None else step_s / (step_s + allreduce_s)


def dp_rows(grad_bytes: int, wall_s, device_s) -> list:
    rows = []
    for n in CARDS:
        t = allreduce_seconds(n, grad_bytes)
        name, rate = link(n)
        rows.append({"cards": n, "link": name, "link_bytes_per_s": rate,
                     "allreduce_ms": t * 1e3,
                     "dp_efficiency_wall": efficiency(wall_s, t),
                     "dp_efficiency_device": efficiency(device_s, t)})
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--steps", type=int, default=50)
    common.add_common_args(parser, "dp_measure")
    args = parser.parse_args(argv)
    device = common.tool_device(args.device)
    on_card = device.type == "cuda"

    g = torch.Generator(device=device).manual_seed(args.seed)
    model = a1_flow(device, g)
    n_params, grad_bytes = common.grad_counts(model)
    config = TrainConfig(batch_size=args.batch, epochs=1, lr=1e-4)
    optimizer = make_optimizer(config)
    step = make_train_step(model, config, optimizer)
    opt_state = [optimizer.init(list(model.parameters()))]
    batch = (torch.rand(args.batch, 6, generator=g, device=device) * 2 - 1
             ) * A1_HALF_BOX

    def one():
        opt_state[0], _ = step(opt_state[0], batch)

    wall_s = 1.0 / common.steady_rate(one, device, args.steps)[0]
    prof = common.device_profile(one, args.steps, device)
    device_s = None if prof["device_ms"] is None else prof["device_ms"] / 1e3

    rows = dp_rows(grad_bytes, wall_s if on_card else None, device_s)
    at8 = next(r for r in rows if r["cards"] == 8)
    result = {
        "metric": "dp_comm_compute",
        "device": common.card(device),
        "n_params": n_params,
        "grad_bytes": grad_bytes,
        "grad_mbytes": round(grad_bytes / 1e6, 2),
        "train_step_ms": wall_s * 1e3,
        "batch": args.batch,
        "steps": args.steps,
        "wall_ms_per_step": wall_s * 1e3,
        "device_ms_per_step": prof["device_ms"],
        "kernels_per_step": prof["kernels"],
        "events_ms_per_step": prof["events_ms"],
        "device_time_source": prof["source"],
        "psum_ms_at_8": at8["allreduce_ms"],
        "dp_efficiency_at_8": at8["dp_efficiency_wall"],
        "dp_efficiency_at_8_device": at8["dp_efficiency_device"],
        "ici_bytes_per_s_assumed": NVLINK_BYTES_PER_S,
        "link_assumptions": {
            "model": "ring all-reduce: 2 (N - 1) / N x grad bytes a card",
            "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
            "nvlink": f"H100 SXM NVLink, one way, up to {CARDS_PER_HOST} "
                      "cards in one host",
            "infiniband_bytes_per_s": IB_BYTES_PER_S,
            "infiniband": "400 Gb/s a card between hosts"},
        "rows": rows,
    }
    if not on_card:
        result["note"] = ("a CPU run: the times are the CPU's; no device "
                          "time, share or efficiency is filled")
    common.write_evidence(args.evidence, result)
    print(json.dumps(common.finite_or_none(result)), flush=True)
    return result


if __name__ == "__main__":
    main()
