"""The port's Algorithm 2 (``flowstate_tpu_torch.experiments.algorithm2``
and ``training/cycles.py``) on the CPU.

Mirrors the JAX driver's tests (``tests/test_experiments.py``: the smoke
run, the fused smoke run, ``freeze_after``) at their sizes, and adds:
the files the port writes equal the JAX driver's at the same config (the
Orbax tree of a checkpoint stands as one ``tree.pt``); the fused runner
and the host loop agree bit for bit; a resumed run continues the saved
state and equals an uninterrupted one; a resumed cumulative run trains on
the saved train set, not on zero rows (ROADMAP R7); the errors.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.analysis import plots as tplots
from flowstate_tpu_torch.experiments import algorithm2
from flowstate_tpu_torch.flows import build_circular_flow, params_to_jax
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS
from flowstate_tpu_torch.training.cycles import make_fused_cycles
from flowstate_tpu_torch.utils.checkpoint import (
    chain_state_from_tree, restore_checkpoint,
)
from flowstate_tpu_torch.utils.config import algorithm2_config

torch.set_num_threads(1)

# the JAX driver tests' size (tests/test_experiments.py:139-230)
SMOKE = dict(num_chains=4, equilibration_steps=200, adjusting_frequency=100,
             sampling_frequency=5, initial_training_num_samples=16,
             update_num_samples=16, batch_size=8, epochs=1, K=2,
             hidden_units=16, num_bins=4, num_training_cycles=4,
             checkpoint_interval=2, num_samples_for_analysis=64,
             num_samples_for_free_energy=8)


def config(out, experiment_id="smoke_a2", **kw):
    return algorithm2_config(experiment_id=experiment_id,
                             output_dir=str(out), **{**SMOKE, **kw})


def files_under(root):
    """Files under ``root``; a JAX checkpoint's Orbax tree directory
    counts as the port's one ``tree.pt``."""
    out = set()
    for d, _, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), root)
            parts = rel.split(os.sep)
            if "checkpoints" in parts and parts[-1] != "metadata.json":
                i = parts.index("checkpoints")
                rel = os.path.join(*parts[:i + 2], "tree.pt")
            out.add(rel)
    return sorted(out)


def flow_leaves(model):
    return jax.tree_util.tree_leaves(params_to_jax(model))


def assert_same_state(a, b):
    for f in TENSOR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(torch.nan_to_num(x, nan=7.0),
                           torch.nan_to_num(y, nan=7.0)), f
    assert (a.seed, a.calls) == (b.seed, b.calls)


def assert_same_flow(a, b):
    for x, y in zip(flow_leaves(a), flow_leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_a2(tmp_path_factory):
    from flowstate_tpu.experiments import algorithm2 as jalgorithm2
    from flowstate_tpu.utils.config import (
        algorithm2_config as j_algorithm2_config,
    )
    out = tmp_path_factory.mktemp("jax_a2")
    jalgorithm2.run(j_algorithm2_config(experiment_id="smoke_a2",
                                        output_dir=str(out), **SMOKE))
    return out


@pytest.mark.parametrize("matplotlib", [True, False])
def test_algorithm2_smoke_writes_the_jax_drivers_files(
        jax_a2, tmp_path, monkeypatch, matplotlib):
    if not matplotlib:
        monkeypatch.setattr(tplots, "_pyplot", lambda: None)
    results = algorithm2.run(config(tmp_path), device="cpu")
    d = results["directory"]
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert "delta_f_mean" in results
    assert results["cycles_run"] == 4 and results["start_cycle"] == 0
    assert np.all(np.isfinite(results["loss_per_cycle"]))
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000004"))
    want = files_under(jax_a2)
    if not matplotlib:
        want = [f for f in want if not f.endswith((".png", ".svg"))]
    assert files_under(tmp_path) == want
    assert np.load(os.path.join(d, "production_positions.npy")).shape == (
        4, 4 * 4, 3, 2)
    with open(jax_a2 / "evidence" / "smoke_a2_data.json") as f:
        j_ev = json.load(f)
    with open(tmp_path / "evidence" / "smoke_a2_data.json") as f:
        t_ev = json.load(f)
    assert set(t_ev) - set(j_ev) == {"phase_s"} and not set(j_ev) - set(t_ev)
    assert t_ev["driver"] == "algorithm2"
    assert t_ev["training_samples_history"] == j_ev[
        "training_samples_history"]


def test_algorithm2_fused_smoke(tmp_path):
    """The fused runner: the JAX test's chunks (4 = 2 x interval, then the
    remainder, 5) and sane statistics."""
    results = algorithm2.run(config(tmp_path, "smoke_a2_fused",
                                    num_training_cycles=5),
                             fused=True, device="cpu")
    d = results["directory"]
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert np.isfinite(results["delta_f_mean"])
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000004"))
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000005"))
    assert os.path.exists(os.path.join(d, "p_acc_vs_training_samples.png"))


def test_algorithm2_freeze_after(tmp_path):
    """A frozen runner leaves the flow's parameters bit-unchanged with NaN
    losses while production moves the chains; the driver runs end to end
    with ``freeze_after``."""
    spec = tops.SystemSpec.create(3, tops.Box.from_density(3, 0.03, 1.0),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)
    model = build_circular_flow(3, 2, 5.0, K=2, hidden_units=8, num_bins=4,
                                device="cpu",
                                generator=torch.Generator().manual_seed(0))
    before = flow_leaves(model)
    cfg = algorithm2_config(num_chains=4, update_num_samples=16,
                            batch_size=8, epochs=1, sampling_frequency=5)
    pos, _ = tmcmc.init_alternating_wells(4, 3, 0.03)
    state = tmcmc.init_chain_state(spec, torch.as_tensor(pos), 1, 0.5)
    state2, out = make_fused_cycles(model, spec, cfg, 2, train=False)(
        state, 0)
    for a, b in zip(before, flow_leaves(model)):
        np.testing.assert_array_equal(a, b)
    assert out["loss"].shape == (2, 1) and bool(torch.isnan(out["loss"]).all())
    assert out["accepts"].shape == (2,)
    assert out["positions"].shape == (2, 4, 4, 3, 2)
    assert not torch.equal(state.positions, state2.positions)

    results = algorithm2.run(config(tmp_path, "smoke_a2_freeze",
                                    num_training_cycles=6),
                             fused=True, freeze_after=2, device="cpu")
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert np.isfinite(results["delta_f_mean"])
    # chunks end at the freeze (2) and then every 2 x interval (6)
    ckpt = os.path.join(results["directory"], "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000006"]
    frozen = [restore_checkpoint(os.path.join(ckpt, f"step_{s:08d}"))[0]
              for s in (2, 6)]
    for a, b in zip(jax.tree_util.tree_leaves(frozen[0]["flow"]),
                    jax.tree_util.tree_leaves(frozen[1]["flow"])):
        assert torch.equal(a, b)
    assert len(results["loss_per_cycle"]) == 1 + 2    # initial + 2 cycles


def test_fused_runner_and_host_loop_agree_bit_for_bit(tmp_path):
    """Four trained cycles and two frozen ones, through each path."""
    kw = dict(num_training_cycles=6, equilibration_steps=100)
    host = algorithm2.run(config(tmp_path / "host", **kw), freeze_after=4,
                          device="cpu")
    fused = algorithm2.run(config(tmp_path / "fused", **kw), fused=True,
                           freeze_after=4, device="cpu")
    assert host["p_acc_history"] == fused["p_acc_history"]
    assert host["loss_per_cycle"] == fused["loss_per_cycle"]
    assert_same_state(host["state"], fused["state"])
    assert_same_flow(host["model"], fused["model"])
    traj = [np.load(os.path.join(r["directory"], "production_positions.npy"))
            for r in (host, fused)]
    np.testing.assert_array_equal(*traj)
    # the checkpoint both write, at cycle 4
    trees = [restore_checkpoint(os.path.join(
        r["directory"], "checkpoints", "step_00000004"))[0]
        for r in (host, fused)]
    for a, b in zip(jax.tree_util.tree_leaves(trees[0]),
                    jax.tree_util.tree_leaves(trees[1])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(torch.nan_to_num(a, nan=7.0),
                               torch.nan_to_num(b, nan=7.0))
        else:
            assert a == b


def test_resume_continues_the_saved_state(tmp_path):
    """A run of 4 cycles resumed to 6 equals an uninterrupted run of 6:
    the chains, the flow and the last two cycles' samples."""
    kw = dict(equilibration_steps=100)
    whole = algorithm2.run(config(tmp_path / "whole", num_training_cycles=6,
                                  **kw), device="cpu")
    first = algorithm2.run(config(tmp_path / "cut", num_training_cycles=4,
                                  **kw), device="cpu")
    ckpt = os.path.join(first["directory"], "checkpoints", "step_00000004")
    saved, meta = restore_checkpoint(ckpt)
    assert meta == {"cycle": 4, "train_set_size": 16}
    assert saved["chains"]["calls"] == first["state"].calls
    assert_same_state(first["state"],
                      chain_state_from_tree(saved["chains"],
                                                       "cpu"))
    resumed = algorithm2.run(config(tmp_path / "cut", num_training_cycles=6,
                                    **kw), resume=True, device="cpu")
    assert resumed["start_cycle"] == 4 and resumed["cycles_run"] == 2
    assert_same_state(resumed["state"], whole["state"])
    assert_same_flow(resumed["model"], whole["model"])
    tail = np.load(os.path.join(whole["directory"],
                                "production_positions.npy"))[:, -2 * 4:]
    np.testing.assert_array_equal(
        np.load(os.path.join(resumed["directory"],
                             "production_positions.npy")), tail)
    with open(tmp_path / "cut" / "evidence" / "smoke_a2_data.json") as f:
        assert json.load(f)["resumed_from_cycle"] == 4


def test_blocked_run_resumes_bit_equal(tmp_path):
    """Blocked moves (N=4, k=1) in the host loop: a run of 4 cycles
    resumed to 6 equals an uninterrupted run of 6 (chains, conditional
    flow, samples); the checkpoint holds the conditional flow's tree, and
    no flow samples are evaluated."""
    kw = dict(equilibration_steps=100, num_particles=4, blocked_k=1,
              blocked_K=2)
    whole = algorithm2.run(config(tmp_path / "whole", num_training_cycles=6,
                                  **kw), device="cpu")
    algorithm2.run(config(tmp_path / "cut", num_training_cycles=4, **kw),
                   device="cpu")
    resumed = algorithm2.run(config(tmp_path / "cut", num_training_cycles=6,
                                    **kw), resume=True, device="cpu")
    assert resumed["start_cycle"] == 4 and resumed["cycles_run"] == 2
    assert_same_state(resumed["state"], whole["state"])
    assert_same_flow(resumed["model"], whole["model"])
    tail = np.load(os.path.join(whole["directory"],
                                "production_positions.npy"))[:, -2 * 4:]
    np.testing.assert_array_equal(
        np.load(os.path.join(resumed["directory"],
                             "production_positions.npy")), tail)
    assert 0.0 <= whole["big_move_acceptance"] <= 1.0
    assert np.all(np.isfinite(whole["loss_per_cycle"]))
    saved, _ = restore_checkpoint(os.path.join(
        whole["directory"], "checkpoints", "step_00000004"))
    assert set(saved["flow"][0]["net"]["blocks"][0]) == {"l1", "l2", "ctx"}
    names = os.listdir(whole["directory"])
    assert not [f for f in names if f.startswith(("heatmap_", "rdf_"))]
    with open(os.path.join(whole["directory"], "experiment.log")) as f:
        assert "conditional flow K=blocked_K=2; K=2 unused" in f.read()


def test_resumed_cumulative_run_keeps_its_train_set(tmp_path):
    """R7: the JAX driver restarts a resumed run's train set from zeros
    and a cumulative window then keeps those zero rows for good.  The
    port restores the saved set: after the resume it holds every earlier
    sample and no zero row."""
    kw = dict(cumulative_training_samples=True, equilibration_steps=100)
    algorithm2.run(config(tmp_path, num_training_cycles=4, **kw),
                   device="cpu")
    algorithm2.run(config(tmp_path, num_training_cycles=8, **kw),
                   resume=True, device="cpu")
    ckpt = os.path.join(tmp_path, "smoke_a2", "checkpoints")
    at4, meta4 = restore_checkpoint(os.path.join(ckpt, "step_00000004"))
    at8, meta8 = restore_checkpoint(os.path.join(ckpt, "step_00000008"))
    assert meta4["train_set_size"] == 16 + 4 * 16
    assert meta8["train_set_size"] == 16 + 8 * 16
    rows = at8["train_set"].numpy()
    assert rows.shape == (144, 6)
    assert not np.any(np.all(rows == 0.0, axis=1))
    np.testing.assert_array_equal(rows[:80], at4["train_set"].numpy())


def test_mixed_loss_runs_in_the_host_loop(tmp_path):
    results = algorithm2.run(config(tmp_path, num_training_cycles=2,
                                    equilibration_steps=100, alpha=0.9),
                             device="cpu")
    assert len(results["loss_per_cycle"]) == 3
    assert np.all(np.isfinite(results["loss_per_cycle"]))


@pytest.mark.parametrize("kw,fused,error,match", [
    (dict(blocked_k=1), True, ValueError, "host-driven"),
    (dict(cumulative_training_samples=True), True, ValueError,
     "non-cumulative"),
    (dict(alpha=0.5), True, ValueError, "alpha"),
    (dict(blocked_k=1, alpha=0.9), False, ValueError, "alpha=1.0"),
])
def test_errors(tmp_path, kw, fused, error, match):
    with pytest.raises(error, match=match):
        algorithm2.run(config(tmp_path, **kw), fused=fused, device="cpu")
    spec = tops.SystemSpec.create(3, tops.Box.from_density(3, 0.03, 1.0))
    model = build_circular_flow(3, 2, 5.0, K=2, hidden_units=8, num_bins=4,
                                device="cpu")
    if fused:
        with pytest.raises(error, match=match):
            make_fused_cycles(model, spec, config(tmp_path, **kw), 1)


def test_recipe_sector_statistics_match_sector_check(tmp_path):
    """The recipe's labels, weights, pure-sector ΔF and bootstrap error
    equal ``tools/sector_check.py``'s on the same trajectories (it rounds
    to 4 decimals)."""
    import importlib.util

    from flowstate_tpu_torch.tools import a2_recipe

    spec = importlib.util.spec_from_file_location(
        "sector_check", os.path.join(os.path.dirname(__file__), os.pardir,
                                     "tools", "sector_check.py"))
    sector_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sector_check)
    rng = np.random.default_rng(11)
    c, t, half_box = 5, 400, 5.0
    centers = np.array([[2.5, 5.0], [7.5, 5.0], [5.0, 0.5]])  # A, B, out
    which = rng.choice(3, size=(c, t, 3), p=[0.45, 0.5, 0.05])
    pos = centers[which] + rng.normal(0.0, 0.2, (c, t, 3, 2))
    path = tmp_path / "production_positions.npy"
    np.save(path, pos.astype(np.float32))
    want = sector_check.main([str(path), "--burn", str(a2_recipe.BURN),
                              "--quad_samples", "2000",
                              "--out", str(tmp_path / "SECTORS.md")])
    window = np.load(path)[:, int(t * a2_recipe.BURN):]
    got = a2_recipe.sector_weights(a2_recipe.sector_labels(window, half_box,
                                                           1.2))
    assert got["samples"] == want["samples_used"]
    for name in a2_recipe.SECTORS:
        assert round(got[name]["weight"], 4) == want["sector_fracs"][name]
    assert round(got["outside"]["weight"], 4) == want["outside_frac"]
    assert round(got["delta_f_pure"]["value"], 4) == want["dF_pure"]
    assert round(got["delta_f_pure"]["err"], 4) == want["dF_pure_err"]


def test_recipe_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    from flowstate_tpu_torch.tools import a2_recipe

    monkeypatch.setattr(a2_recipe, "algorithm2_config", lambda **kw: (
        algorithm2_config(**{**SMOKE, "equilibration_steps": 100, **kw})))
    evidence = tmp_path / "evidence" / "a2_recipe_torch_data.json"
    doc = a2_recipe.main(["--cycles", "4", "--freeze_after", "2",
                          "--output_dir", str(tmp_path), "--evidence",
                          str(evidence), "--device", "cpu"])
    assert doc["card"] == "cpu" and doc["cycles"] == 4
    assert doc["window_samples_per_chain"] == 4 * 4 - int(4 * 4 * 0.55)
    assert set(doc["sectors"]) >= {"AAA", "AAB", "ABB", "BBB", "outside",
                                   "delta_f_pure"}
    with open(evidence) as f:
        assert json.load(f)["cycles"] == 4
