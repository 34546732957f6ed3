"""The port's roofs and roofline tools against the JAX package's.

* ``utils/roofs.py::matmul_flops`` against JAX's ``dot_flops`` on JAX's
  own cases, exactly; on the circular flow's ``log_prob`` and one
  training step (K=2, hidden 16, 4 bins, batch 8) against JAX's count
  with every trip of the scanned layers counted.  XLA's cost analysis,
  and ``dot_flops`` of the compiled text, count a ``while`` body once
  (R17), so ``trip_dot_flops`` below weights each computation of the
  optimized HLO by the trip counts of the loops that call it.
* The published peaks and the roofs' fallbacks, over the files in their
  writers' layout; ``tools/n_scaling.py``'s bounds divide by the same
  constants.
* ``dp_measure``'s counts at Algorithm 1's full widths against JAX's
  parameter tree: 5,100,570 parameters, 20,402,280 gradient bytes.
* ``train_roofline``, ``dp_measure`` and ``scaling_check`` with
  ``--device cpu`` at cut sizes: the JAX tools' keys (read from their
  sources), the device named ``cpu`` and no device metric filled.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.flows import build_circular_flow as jax_flow
from flowstate_tpu.training import (
    TrainConfig as JTrainConfig, TrainState as JTrainState,
    make_optimizer as jax_optimizer, make_train_step as jax_train_step,
)
from flowstate_tpu.utils.roofs import dot_flops
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.tools import (
    common, dp_measure, n_scaling, scaling_check, train_roofline,
)
from flowstate_tpu_torch.training import (
    TrainConfig, make_optimizer, make_train_step,
)
from flowstate_tpu_torch.utils import roofs
from test_torch_tools import all_finite, jax_result_keys, run_tool

torch.set_num_threads(1)

TINY = dict(K=2, hidden_units=16, num_bins=4)
BATCH = 8


# ----- JAX's dot count with the loops' trips ------------------------------

_HEAD = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(.*\{\s*$")
_CALLS = re.compile(r"\b(body|condition|calls|to_apply)=%([\w.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


class _Text:
    """A piece of HLO text in the shape ``dot_flops`` reads."""

    def __init__(self, text):
        self.text = text

    def as_text(self):
        return self.text


def trip_dot_flops(compiled) -> float:
    """JAX's ``dot_flops`` of each computation of the optimized HLO,
    weighted by how often the program runs it: a ``while`` body by its
    known trip count, times its caller's weight."""
    comps, entry, cur = {}, None, None
    for line in compiled.as_text().splitlines():
        head = _HEAD.match(line)
        if head:
            cur = head.group(1)
            comps[cur] = []
            if line.startswith("ENTRY"):
                entry = cur
        elif cur is not None:
            comps[cur].append(line)

    def weight_of(comp, weight):
        total = weight * dot_flops(_Text("\n".join(comps[comp])))
        for line in comps[comp]:
            trip = _TRIP.search(line)
            for kind, callee in _CALLS.findall(line):
                if kind == "body":
                    assert trip, f"a while without a known trip: {line[:80]}"
                    total += weight_of(callee, weight * int(trip.group(1)))
                else:
                    total += weight_of(callee, weight)
        return total

    return weight_of(entry, 1)


def jax_batch():
    return jax.random.uniform(jax.random.key(1), (BATCH, 6), minval=-5.0,
                              maxval=5.0)


def jax_counts(scan_layers: bool) -> dict:
    """JAX's dot counts of ``log_prob`` and of one training step of the
    tiny flow: ``once`` as ``dot_flops`` reads them, ``trips`` with every
    trip."""
    model = jax_flow(3, 2, 5.0, scan_layers=scan_layers, **TINY)
    params = model.init_params(jax.random.key(0))
    x = jax_batch()
    lp = jax.jit(model.log_prob).lower(params, x).compile()
    config = JTrainConfig(batch_size=BATCH, epochs=1)
    opt = jax_optimizer(config)
    st = JTrainState(params, opt.init(params), jax.random.key(2))
    step = jax.jit(jax_train_step(model, config, opt)).lower(st, x).compile()
    return {"log_prob": dot_flops(lp), "log_prob_trips": trip_dot_flops(lp),
            "step": dot_flops(step), "step_trips": trip_dot_flops(step)}


def port_counts() -> dict:
    g = torch.Generator().manual_seed(0)
    model = build_circular_flow(3, 2, 5.0, generator=g, device="cpu", **TINY)
    x = torch.tensor(np.asarray(jax_batch()))
    config = TrainConfig(batch_size=BATCH, epochs=1)
    opt = make_optimizer(config)
    step = make_train_step(model, config, opt)
    state = opt.init(list(model.parameters()))
    return {"log_prob": roofs.matmul_flops(model.log_prob, x),
            "step": roofs.matmul_flops(step, state, x)}


@pytest.fixture(scope="module")
def counts():
    return {"jax_scan": jax_counts(True), "jax_layers": jax_counts(False),
            "port": port_counts()}


# ----- matmul_flops ---------------------------------------------------------

def _relu_chain(a, b, c, relu):
    return relu(a @ b) @ c


def _batched(x, y, einsum):
    return einsum("bij,bjk->bik", x, y)


@pytest.mark.parametrize("case", ["relu_chain", "batched_einsum"])
def test_matmul_flops_equals_dot_flops_on_jax_cases(case):
    """tests/test_utils_infra.py::test_roofs_dot_flop_classifier's two
    programs, on the same shapes in both packages."""
    if case == "relu_chain":
        shapes = [(64, 32), (32, 48), (48, 16)]
        jfn = lambda *a: _relu_chain(*a, jax.nn.relu)  # noqa: E731
        tfn = lambda *a: _relu_chain(*a, torch.relu)  # noqa: E731
    else:
        shapes = [(4, 8, 16), (4, 16, 8)]
        jfn = lambda *a: _batched(*a, jnp.einsum)  # noqa: E731
        tfn = lambda *a: _batched(*a, torch.einsum)  # noqa: E731
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    expected = dot_flops(jax.jit(jfn).lower(*map(jnp.asarray, arrays))
                         .compile())
    got = roofs.matmul_flops(tfn, *map(torch.as_tensor, arrays))
    assert got == expected
    assert got == (2 * 64 * 32 * 48 + 2 * 64 * 48 * 16
                   if case == "relu_chain" else 2 * 4 * 8 * 8 * 16)


def test_matmul_flops_of_log_prob_counts_every_layer(counts):
    """The port's log_prob runs JAX's products with every one of the K
    scanned layers counted: JAX's count once a trip (R17) and its
    unscanned flow's count, both exactly."""
    port = counts["port"]["log_prob"]
    assert port == counts["jax_scan"]["log_prob_trips"]
    assert port == counts["jax_layers"]["log_prob"]
    # R17: dot_flops of the scanned program counts the body once
    assert counts["jax_scan"]["log_prob"] * TINY["K"] == port


def test_matmul_flops_of_a_training_step_against_jax(counts):
    """One step's products, the backward's included: the port's count is
    JAX's unscanned step exactly.  JAX's scanned step, every trip
    counted, adds two products the port does not run, and only these:
    ``jax.checkpoint`` on the scanned layer (flows/core.py:282) runs each
    layer's forward products again in the backward (K x the log_prob
    products), and inside the scan layer 0's first dense layer takes an
    input gradient that the unscanned program drops: (B, hidden) x
    (hidden, 6), the 6 the cos and sin of the conditioner's 3 inputs."""
    port = counts["port"]["step"]
    assert port == counts["jax_layers"]["step"]
    assert counts["jax_layers"]["step"] == counts["jax_layers"]["step_trips"]
    remat = counts["jax_scan"]["log_prob_trips"]
    layer0_input_grad = 2 * BATCH * TINY["hidden_units"] * 6
    assert counts["jax_scan"]["step_trips"] == port + remat + layer0_input_grad
    # R17 again: the body counted once falls short of the step
    assert counts["jax_scan"]["step"] < port


# ----- peaks and roofs ------------------------------------------------------

def test_published_peaks_and_the_bounds_that_divide_by_them():
    assert (roofs.PEAK_FP32_FLOPS, roofs.PEAK_TF32_FLOPS,
            roofs.PEAK_BF16_FLOPS, roofs.PEAK_BYTES_PER_S) == (
        67e12, 495e12, 989e12, 3.35e12)
    assert n_scaling.PEAK_FP32_FLOPS is roofs.PEAK_FP32_FLOPS
    assert n_scaling.PEAK_BYTES_PER_S is roofs.PEAK_BYTES_PER_S
    assert roofs.peak_flops(None) == roofs.peak_flops(torch.float32) == 67e12
    assert roofs.peak_flops("bfloat16") == 989e12
    # the bounds' values before the peaks moved to utils/roofs.py
    ops = 16384 * 1000 * (2 * 2 * 22 + 2 * 2 * 22 + 18)
    assert n_scaling.k1_bound(16384, 3, 2, 1000) == (
        1e3 * max(ops / 67e12, 16384 * (2 * 3 * 2 * 4 + 16) / 3.35e12),
        "operations")
    assert n_scaling.k2_bound(100, 3, 2) == (
        1e3 * max((300 * 13 + 300 * 13 + 600 * 22) / 67e12,
                  100 * (3 * 2 * 4 + 8) / 3.35e12), "bytes")
    assert n_scaling.k3_bound(528 * 1024, 16, 8, 256) == (
        1e3 * 2 * 16 * 8 * 256 * 528 * 1024 / 67e12, "operations")


def test_roofs_read_only_a_cards_calibration(tmp_path, monkeypatch):
    """The roofs read the files in the layout their writers give them:
    ``n_scaling.main``'s own output (a CPU run here: refused), and a
    card's, whose ``device`` is ``common.card_fields`` as both writers
    set it; a file counts only where its card and power limit are the
    card's now."""
    import functools
    import json

    fp32_path = tmp_path / "n_scaling.json"
    matmul_path = tmp_path / "matmul_roof.json"
    monkeypatch.setattr(roofs, "N_SCALING_PATH", str(fp32_path))
    monkeypatch.setattr(roofs, "MATMUL_ROOF_PATH", str(matmul_path))
    assert roofs.fp32_roof() == 67e12              # no file
    assert roofs.matmul_roof("bfloat16") == 989e12
    # n_scaling's CPU run cut to 8 chains, one move, a short probe
    monkeypatch.setattr(n_scaling, "calibrate_fp32_ops", functools.partial(
        n_scaling.calibrate_fp32_ops, iters=4))
    monkeypatch.setattr(n_scaling, "chains_for", lambda n: 8)
    written = n_scaling.main(["--ns", "8", "--moves", "1", "--repeats", "1",
                              "--plain_moves", "1", "--device", "cpu",
                              "--out", str(fp32_path)])
    assert written["device"] == common.card_fields("cpu")
    assert written["fp32_ops_per_s"] > 0
    assert roofs.fp32_roof("cpu") == roofs.fp32_roof() == 67e12

    # a card, as the card's machine shows it
    h100 = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: h100)
    monkeypatch.setattr(common, "card", lambda *_: f"{h100}, 700.00 W")
    assert roofs.fp32_roof() == 67e12              # a CPU run's: refused
    assert roofs.fp32_roof("cpu") == 67e12
    on_card = dict(written, device=common.card_fields("cuda"),
                   fp32_ops_per_s=6.5e13)
    assert on_card["device"] == {"name": h100, "power_limit": "700.00 W"}
    fp32_path.write_text(json.dumps(on_card))
    matmul_path.write_text(json.dumps({
        "device": common.card_fields("cuda"), "float32_flops_per_s": 5e13,
        "float32_dim": 4096}))
    assert roofs.fp32_roof() == 6.5e13
    assert roofs.matmul_roof(torch.float32) == 5e13
    assert roofs.matmul_roof(torch.bfloat16) == 989e12   # not calibrated
    assert roofs.fp32_roof("cpu") == 67e12
    # the same card at another power limit: its calibration does not hold
    monkeypatch.setattr(common, "card", lambda *_: f"{h100}, 500.00 W")
    assert roofs.fp32_roof() == 67e12
    assert roofs.matmul_roof(torch.float32) == 67e12
    with pytest.raises(ValueError, match="no roof"):
        roofs.peak_flops(torch.float64)


def test_calibration_needs_a_card():
    with pytest.raises(ValueError, match="a roof is the card's"):
        roofs.calibrate_matmul_roof(dim=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofs.calibrate_matmul_roof(dim=8)


# ----- the profiler's device time --------------------------------------------

def test_device_profile_keeps_event_time_apart(monkeypatch):
    """The profiler's kernel time is ``device_ms``; where it keeps no
    record of the window (F6), the CUDA events' time around the window is
    ``events_ms`` and ``device_ms`` stays None.  The card's parts are
    stood in for: the profiler's records and a CPU clock for the events."""
    from types import SimpleNamespace

    calls = []
    assert common.device_profile(lambda: calls.append(1), 4, "cpu") == {
        "device_ms": None, "kernels": None, "events_ms": None,
        "source": None}
    assert calls == []
    kernel = SimpleNamespace(time_range=SimpleNamespace(
        elapsed_us=lambda: 250.0))
    monkeypatch.setattr(common, "device_events",
                        lambda fn, reps: [kernel] * (2 * reps))
    assert common.device_profile(lambda: None, 4, "cuda") == {
        "device_ms": 0.5, "kernels": 2.0, "events_ms": None,
        "source": "profiler"}
    monkeypatch.setattr(common, "device_events", lambda fn, reps: [])
    monkeypatch.setattr(common, "HostLoopTimer", lambda device: _CpuTimer())
    prof = common.device_profile(lambda: calls.append(1), 4, "cuda")
    assert calls == [1] * 4
    assert prof["device_ms"] is None and prof["kernels"] is None
    assert prof["source"] == "events" and prof["events_ms"] > 0


class _CpuTimer(common.HostLoopTimer):
    """``HostLoopTimer`` on the host clock, for a window said to be the
    card's."""

    def __init__(self):
        super().__init__("cpu")


# ----- dp_measure's counts --------------------------------------------------

def test_dp_measure_counts_a1_flow_like_jax():
    model = dp_measure.a1_flow("cpu", torch.Generator().manual_seed(0))
    n_params, grad_bytes = common.grad_counts(model)
    leaves = jax.tree_util.tree_leaves(jax.eval_shape(
        jax_flow(3, 2, 5.0, K=15, hidden_units=256, num_bins=32,
                 num_blocks=2).init_params, jax.random.key(0)))
    assert n_params == sum(int(x.size) for x in leaves) == 5_100_570
    assert grad_bytes == sum(int(x.size) * x.dtype.itemsize
                             for x in leaves) == 20_402_280


def test_dp_measure_allreduce_model():
    assert dp_measure.allreduce_seconds(8, 20_402_280) == (
        2 * 7 / 8 * 20_402_280 / 450e9)
    assert dp_measure.allreduce_seconds(16, 1000) == 2 * 15 / 16 * 1000 / 50e9
    rows = dp_measure.dp_rows(1000, 1e-3, None)
    assert [r["cards"] for r in rows] == [2, 4, 8, 16, 64, 256]
    assert all(r["dp_efficiency_device"] is None for r in rows)
    assert rows[0]["dp_efficiency_wall"] == 1e-3 / (
        1e-3 + dp_measure.allreduce_seconds(2, 1000))


# ----- the tools on the CPU -------------------------------------------------

def no_device_metric(row: dict, keys) -> bool:
    return all(row[k] is None for k in keys)


def test_train_roofline_main(tmp_path, monkeypatch):
    monkeypatch.setattr(train_roofline, "FLOW", dict(TINY, num_blocks=2))
    monkeypatch.setattr(train_roofline, "TRAIN_SET", 64)
    monkeypatch.setattr(train_roofline, "NUM_CHAINS", 64)
    monkeypatch.setattr(train_roofline, "GATE_EPOCHS", 1)
    monkeypatch.setattr(train_roofline, "GATE_BATCH", BATCH)
    monkeypatch.setattr(common, "MIN_WINDOW_S", 0.02)
    res = run_tool(train_roofline, ["--batches", str(BATCH)], tmp_path,
                   monkeypatch)
    assert set(jax_result_keys("train_roofline", "results", "main")) <= set(res)
    assert res["device"] == "cpu"
    assert res["matmul_roof_from_file"] == {"f32": False, "bfloat16": False}
    roof_keys = jax_result_keys("train_roofline", "out", "_roofline")
    device_metrics = {
        "device_ms_per_call", "kernels_per_call", "events_ms_per_call",
        "mxu_frac_bf16peak",
        *(f"{m}{s}" for s in ("", "_device") for m in (
            "delivered_gflops", "delivered_gbytes", "frac_of_peak",
            "frac_of_matmul_roof", "hbm_frac"))}
    train_keys = jax_result_keys("train_roofline", "row", "train_phase")
    assert [r["dtype"] for r in res["train"]] == ["f32", "bfloat16"]
    for row in res["train"]:
        assert (train_keys | roof_keys) <= set(row)
        assert no_device_metric(row, device_metrics)
        assert row["steps_per_s"] > 0
        assert row["matmul_flops"] == port_counts()["step"]
    gate = res["train_quality_gate"]
    assert jax_result_keys("train_roofline", "gate", "train_phase") <= set(gate)
    assert isinstance(gate["ok"], bool) and len(gate["f32_loss_epochs"]) == 1
    big_keys = jax_result_keys("train_roofline", "row", "big_move_phase")
    for row in res["big_move"]:
        assert (big_keys | roof_keys) <= set(row)
        assert no_device_metric(row, device_metrics)
    for tag in ("f32", "bfloat16"):
        comps = res[f"big_move_components_{tag}"]
        assert set(comps) == {"sample_and_log_prob", "log_prob_old",
                              "pair_energies",
                              "sample_and_log_prob_with_old"}
        for c in comps.values():
            assert {"calls_per_s", "ms_per_call"} <= set(c)
            assert c["device_ms"] is None and c["kernels"] is None
            assert c["events_ms"] is None
        # the round's paired pass: the forward and the inverse sweep
        assert comps["sample_and_log_prob_with_old"]["matmul_flops"] == (
            comps["sample_and_log_prob"]["matmul_flops"]
            + comps["log_prob_old"]["matmul_flops"])
    assert all_finite(res)


def test_dp_measure_main(tmp_path, monkeypatch):
    res = run_tool(dp_measure, ["--batch", str(BATCH), "--steps", "2"],
                   tmp_path, monkeypatch)
    assert set(jax_result_keys("dp_measure", "result", "main")) <= set(res)
    assert res["device"] == "cpu"
    assert (res["n_params"], res["grad_bytes"]) == (5_100_570, 20_402_280)
    assert res["device_ms_per_step"] is None and res["kernels_per_step"] is None
    assert res["events_ms_per_step"] is None
    assert res["dp_efficiency_at_8"] is None
    assert all(r["dp_efficiency_wall"] is None
               and r["dp_efficiency_device"] is None for r in res["rows"])
    assert res["psum_ms_at_8"] == 1e3 * dp_measure.allreduce_seconds(
        8, 20_402_280)
    assert all_finite(res)


def test_scaling_check_main(tmp_path, monkeypatch):
    for name, value in (("CHAINS_PER_RANK", 64), ("MOVES", 10),
                        ("BATCH_PER_RANK", BATCH), ("STEPS", 2)):
        monkeypatch.setattr(scaling_check, name, value)
    res = run_tool(scaling_check, ["--world_sizes", "1", "2"], tmp_path,
                   monkeypatch)
    assert res["device"] == "cpu" and res["backend"] == "gloo"
    assert (res["chains_per_rank"], res["moves"], res["batch_per_rank"],
            res["steps"]) == (64, 10, BATCH, 2)
    assert res["not_run"] == {}
    assert [(r["devices"], r["chains"]) for r in res["mcmc"]] == [
        (1, 64), (2, 128)]
    assert [(r["devices"], r["global_batch"]) for r in res["training"]] == [
        (1, BATCH), (2, 2 * BATCH)]
    for rows, rate in ((res["mcmc"], "moves_per_s"),
                       (res["training"], "samples_per_s")):
        assert rows[0]["efficiency"] == 1.0
        assert all(r[rate] > 0 and r["efficiency"] > 0 for r in rows)
    assert all(r["k1_launches"] == 0 for r in res["mcmc"])   # no kernel
    assert all_finite(res)
