"""Algorithm 1's training step and 16,384-chain big-move round against the
card's roofs.

Port of ``tools/train_roofline.py``.  For each variant it times the call
on the card and sets it against ``utils/roofs.py``:

* the training step (K=15, hidden 256, 32 bins) over 102,400 uniform
  points in the box, at each of ``--batches``, in float32 and with the
  residual net in bf16 (``compute_dtype="bfloat16"``): steps/s by the
  host clock over a window of at least 0.6 s, device ms and kernels per
  step by the profiler over as many steps, the step's matmul FLOP
  (``roofs.matmul_flops``, every layer counted: JAX's XLA cost analysis
  counts the scanned K layers once, R17), and the least bytes a step
  needs (parameters read, gradients written, Adam's two moments read and
  written, parameters written, the batch read once: a lower bound counted
  from the shapes; no measured byte count exists on the card's machine);
* delivered FLOP/s against the published peak of the dtype (float32
  67e12 without TF32, bf16 989e12) and against ``matmul_roof`` (this
  card's calibration where one is on file, else the peak), by wall and
  by device time; bytes against 3.35e12;
* the bf16 quality gate as JAX runs it: 10 epochs at batch 512 on the
  same data and seeds, ``ok`` where the final losses differ by less than
  2% relative;
* the big-move round (``nf_big_moves``, the paired pass by default) at
  16,384 chains of the reference system, and its parts: the proposal's
  ``sample_and_log_prob``, ``log_prob`` of the old state, the pair
  energies through K2, and the paired pass that the round runs.

The profiler loses device records (F6), K2's among them.  Where it
records no event of a window, the device time and kernel count stay null
and ``events_ms`` holds the milliseconds a call between two CUDA events:
the host's dispatch and the card's work together, not a kernel time.  A
round's device time and kernel count are of the records kept, and leave
out a K2 launch that the profiler lost.

On the CPU (``--device cpu``) it runs the same code; no device time,
kernel count or share of a card's peak is filled there.  The JSON has
the JAX tool's keys and the port's fields; ``--evidence`` writes it.

    python -m flowstate_tpu_torch.tools.train_roofline --evidence
"""

from __future__ import annotations

import argparse
import json

import torch

from flowstate_tpu_torch.entry import A1_FLOW, A1_HALF_BOX
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves, to_centered
from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
from flowstate_tpu_torch.mcmc.state import (
    batched_energy_virial, init_chain_state,
)
from flowstate_tpu_torch.tools import common
from flowstate_tpu_torch.training import (
    TrainConfig, make_optimizer, make_train_step, train,
)
from flowstate_tpu_torch.utils import roofs

NUM_CHAINS = 16384
TRAIN_SET = 102400
FLOW = A1_FLOW
HALF_BOX = A1_HALF_BOX
# the bf16 gate: epochs and batch of the JAX tool's gate
GATE_EPOCHS = 10
GATE_BATCH = 512
GATE_RTOL = 0.02
DTYPES = (None, "bfloat16")


def tag(compute_dtype) -> str:
    return compute_dtype or "f32"


def flow(device, seed: int, compute_dtype=None):
    g = torch.Generator(device=device).manual_seed(seed)
    return build_circular_flow(3, 2, HALF_BOX, generator=g, device=device,
                               compute_dtype=compute_dtype, **FLOW)


def train_step_bytes(model, batch: torch.Tensor) -> int:
    """The least bytes a step moves: parameters read, gradients written,
    Adam's two moments read and written, parameters written (7 x the
    parameters' bytes) and the batch read once."""
    return (7 * common.grad_counts(model)[1]
            + batch.numel() * batch.element_size())


def big_move_bytes(model, state) -> int:
    """The least bytes a round moves: the parameters read once, the
    chains' positions, energies, virials and counts read and written."""
    per_chain = sum(getattr(state, f)[0].numel() * getattr(state, f)
                    .element_size() for f in ("positions", "energy",
                                              "virial", "attempts",
                                              "accepts"))
    return (common.grad_counts(model)[1]
            + 2 * state.positions.shape[0] * per_chain)


def roofline(flops: int, nbytes: int, per_s: float, device_ms, dtype,
             device) -> dict:
    """The JAX tool's roofline fields and the port's: delivered FLOP/s
    and bytes/s by wall time and by device time, their shares of the
    dtype's published peak, of the matmul roof and of the HBM rate.  Off
    the card only the counts are filled."""
    on_card = torch.device(device).type == "cuda"
    out = {"matmul_flops": flops, "gflops_per_call": flops / 1e9,
           "bytes_lower_bound": nbytes, "gbytes_per_call": nbytes / 1e9,
           "calls_per_s": per_s,
           "arith_intensity": flops / nbytes if nbytes else None}
    rates = {"": per_s,
             "_device": 1e3 / device_ms if device_ms else None}
    peak, roof = roofs.peak_flops(dtype), roofs.matmul_roof(dtype, device)
    out.update(peak_flops=peak, matmul_roof=roof)
    for suffix, rate in rates.items():
        rate = rate if on_card else None
        fill = rate is not None
        out.update({
            f"delivered_gflops{suffix}": flops * rate / 1e9 if fill else None,
            f"delivered_gbytes{suffix}": nbytes * rate / 1e9 if fill else None,
            f"frac_of_peak{suffix}": flops * rate / peak if fill else None,
            f"frac_of_matmul_roof{suffix}": (flops * rate / roof if fill
                                             else None),
            f"hbm_frac{suffix}": (nbytes * rate / roofs.PEAK_BYTES_PER_S
                                  if fill else None)})
    out["mxu_frac_bf16peak"] = (flops * per_s / roofs.PEAK_BF16_FLOPS
                                if on_card else None)
    return out


def timed_row(fn, device, nbytes: int, dtype) -> dict:
    """Rate, device time and roofline of ``fn()``: the wall window, a
    profiled window of as many calls, then the FLOP count of one call."""
    per_s, calls = common.steady_rate(fn, device)
    prof = common.device_profile(fn, calls, device)
    return {"window_calls": calls, "device_ms_per_call": prof["device_ms"],
            "kernels_per_call": prof["kernels"],
            "events_ms_per_call": prof["events_ms"],
            "device_time_source": prof["source"],
            **roofline(roofs.matmul_flops(fn), nbytes, per_s,
                       prof["device_ms"], dtype, device)}


def training_set(device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(TRAIN_SET, 6, generator=g, device=device) * 2 - 1
            ) * HALF_BOX


def train_phase(results: dict, batches, dtypes, device, seed: int,
                card: str) -> None:
    data = training_set(device, seed + 8)
    for compute_dtype in dtypes:
        for batch in batches:
            model = flow(device, seed + 7, compute_dtype)
            config = TrainConfig(batch_size=batch, epochs=1, lr=1e-4)
            optimizer = make_optimizer(config)
            step = make_train_step(model, config, optimizer)
            g = torch.Generator(device=device).manual_seed(seed + 9)
            order = torch.randperm(TRAIN_SET, generator=g, device=device)
            parts = data[order].split(batch)[:TRAIN_SET // batch]
            carry = {"opt": optimizer.init(list(model.parameters())), "i": 0}

            def one():
                carry["opt"], _ = step(carry["opt"],
                                       parts[carry["i"] % len(parts)])
                carry["i"] += 1

            row = {"phase": "train", "dtype": tag(compute_dtype),
                   "batch": batch, "card": card,
                   **timed_row(one, device,
                               train_step_bytes(model, parts[0]),
                               compute_dtype)}
            row["steps_per_s"] = row["calls_per_s"]
            results["train"].append(row)
            print(json.dumps(common.finite_or_none(row)), flush=True)


def quality_gate(device, seed: int) -> dict:
    """JAX's gate: the same data and seeds through the float32 and the
    bf16 flow, GATE_EPOCHS epochs at GATE_BATCH; ``ok`` where the final
    losses differ by less than GATE_RTOL relative."""
    data = training_set(device, seed + 8)
    finals = {}
    for compute_dtype in DTYPES:
        model = flow(device, seed + 7, compute_dtype)
        g = torch.Generator(device=device).manual_seed(seed + 12)
        config = TrainConfig(batch_size=GATE_BATCH, epochs=GATE_EPOCHS,
                             lr=1e-4)
        _, _, _, loss_epoch = train(model, data, config, g)
        finals[tag(compute_dtype)] = loss_epoch
    f32, bf16 = finals["f32"][-1], finals["bfloat16"][-1]
    gate = {"phase": "train_quality_gate", "f32_final_loss": f32,
            "bf16_final_loss": bf16,
            "rel_diff": abs(bf16 - f32) / max(abs(f32), 1e-9),
            "f32_loss_epochs": finals["f32"],
            "bf16_loss_epochs": finals["bfloat16"],
            "epochs": GATE_EPOCHS, "batch": GATE_BATCH,
            "train_set": TRAIN_SET, "rtol": GATE_RTOL}
    gate["ok"] = bool(gate["rel_diff"] < GATE_RTOL)
    return gate


def big_move_phase(results: dict, dtypes, device, seed: int,
                   card: str) -> None:
    spec = common.double_well_spec(3)
    positions, _ = init_alternating_wells(NUM_CHAINS, 3, 0.03)
    state0 = init_chain_state(spec, torch.as_tensor(positions,
                                                    device=device),
                              seed, 0.65)
    old = to_centered(state0.positions, HALF_BOX)
    for compute_dtype in dtypes:
        model = flow(device, seed + 7, compute_dtype)
        g = torch.Generator(device=device).manual_seed(seed + 3)
        carry = {"state": state0}

        def round_():
            carry["state"] = nf_big_moves(spec, 1.0, carry["state"], model,
                                          HALF_BOX, g).state

        row = {"phase": "big_move", "dtype": tag(compute_dtype),
               "chains": NUM_CHAINS, "card": card,
               **timed_row(round_, device,
                           big_move_bytes(model, state0), compute_dtype)}
        row["rounds_per_s"] = row["calls_per_s"]
        row["big_moves_per_s"] = row["calls_per_s"] * NUM_CHAINS
        results["big_move"].append(row)
        print(json.dumps(common.finite_or_none(row)), flush=True)

        parts = {
            "sample_and_log_prob":
                lambda: model.sample_and_log_prob(NUM_CHAINS, g),
            "log_prob_old": lambda: model.log_prob(old),
            "pair_energies":
                lambda: batched_energy_virial(spec, state0.positions),
            "sample_and_log_prob_with_old":
                lambda: model.sample_and_log_prob_with_old(NUM_CHAINS, old,
                                                           g),
        }
        comps = {}
        with torch.no_grad():
            for name, fn in parts.items():
                per_s, calls = common.steady_rate(fn, device)
                prof = common.device_profile(fn, calls, device)
                comps[name] = {"calls_per_s": per_s,
                               "ms_per_call": 1e3 / per_s,
                               "device_ms": prof["device_ms"],
                               "kernels": prof["kernels"],
                               "events_ms": prof["events_ms"],
                               "matmul_flops": roofs.matmul_flops(fn)}
                print(json.dumps(common.finite_or_none(
                    {"phase": "big_move_component",
                     "dtype": tag(compute_dtype), "component": name,
                     **comps[name]})), flush=True)
        results[f"big_move_components_{tag(compute_dtype)}"] = comps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[512, 2048, 8192])
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_big", action="store_true")
    ap.add_argument("--skip_gate", action="store_true")
    ap.add_argument("--f32_only", action="store_true")
    common.add_common_args(ap, "train_roofline")
    args = ap.parse_args(argv)
    device = common.tool_device(args.device)
    on_card = device.type == "cuda"
    card = common.card(device)
    if max(args.batches) > TRAIN_SET:
        raise ValueError(f"--batches must not exceed the {TRAIN_SET} "
                         f"training points, got {max(args.batches)}")

    dtypes = DTYPES[:1] if args.f32_only else DTYPES
    results = {"device": card,
               "hbm_roof_gbps": roofs.PEAK_BYTES_PER_S / 1e9,
               "bf16_peak_tflops": roofs.PEAK_BF16_FLOPS / 1e12,
               "fp32_peak_tflops": roofs.PEAK_FP32_FLOPS / 1e12,
               "matmul_roof_flops_per_s": {
                   tag(d): roofs.matmul_roof(d, device) for d in dtypes},
               # True: this card's calibration read from MATMUL_ROOF_PATH
               # (made before this run); False: the published peak
               "matmul_roof_from_file": {
                   tag(d): roofs.matmul_roof(d, device) != roofs.peak_flops(d)
                   for d in dtypes},
               "flow": dict(FLOW), "train_set": TRAIN_SET,
               "train": [], "big_move": []}
    if not on_card:
        results["note"] = ("a CPU run: rates are the CPU's; no device "
                           "time, kernel count or share is filled")
    if args.skip_gate or args.f32_only:
        results["train_quality_gate"] = "skipped"
    if not args.skip_train:
        train_phase(results, args.batches, dtypes, device, args.seed, card)
        if not (args.skip_gate or args.f32_only):
            gate = quality_gate(device, args.seed)
            results["train_quality_gate"] = gate
            print(json.dumps(common.finite_or_none(
                {k: v for k, v in gate.items()
                 if not k.endswith("epochs")})), flush=True)
    if not args.skip_big:
        big_move_phase(results, dtypes, device, args.seed, card)
    for row in results["train"] + results["big_move"]:
        print(f"{card}: {row['phase']} {row['dtype']} "
              f"{row.get('batch', row.get('chains'))}: "
              f"{row['calls_per_s']:.4g}/s, of peak "
              f"{row['frac_of_peak']} (wall) {row['frac_of_peak_device']} "
              f"(device), of HBM {row['hbm_frac']}", flush=True)
    common.write_evidence(args.evidence, results)
    return results


if __name__ == "__main__":
    main()
