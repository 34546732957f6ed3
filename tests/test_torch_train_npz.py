"""The port's NPZ trainer (``experiments/train_npz.py``) against the JAX
package's: a tiny NPZ with repeated rows, the deduplicated and subsampled
training set equal to what the JAX ``dedup_subsample`` keeps (the count
and the rows), a finite loss, and the files written: the pickled flow in
the JAX layout (loaded back through the JAX model's ``load`` with the
JAX tree structure), the loss, heatmap and pair-correlation data."""

import json

import jax
import numpy as np

from flowstate_tpu.flows import build_circular_flow as jax_build_flow
from flowstate_tpu.training import dedup_subsample as jax_dedup
from flowstate_tpu_torch.experiments import train_npz
from flowstate_tpu_torch.training import dedup_subsample

ARGS = ["--K", "2", "--hidden_units", "16", "--num_bins", "4",
        "--half_box", "5.0", "--batch_size", "32", "--epochs", "2",
        "--eval_samples", "400", "--device", "cpu"]


def test_train_npz_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    rows = rng.uniform(-4.5, 4.5, (90, 3, 2)).astype(np.float32)
    configs = np.concatenate([rows, rows[:30], rows[5:25]])   # 50 repeats
    path = tmp_path / "configs.npz"
    np.savez(path, configs=configs)

    flat = configs.reshape(len(configs), 6)
    assert len(dedup_subsample(flat)) == len(jax_dedup(flat)) == 90
    np.testing.assert_array_equal(dedup_subsample(flat, 40, seed=3),
                                  jax_dedup(flat, 40, seed=3))

    out = tmp_path / "out"
    res = train_npz.main(["--npz_path", str(path), "--output_path",
                          str(out)] + ARGS)
    assert res["num_samples"] == 90
    assert np.isfinite(res["final_loss"])
    res40 = train_npz.main(["--npz_path", str(path), "--output_path",
                            str(tmp_path / "out40"), "--max_samples", "40",
                            "--seed", "3"] + ARGS)
    assert res40["num_samples"] == 40

    written = {p.name for p in out.iterdir()}
    assert {"trained_model.pkl", "frequency_heatmap_data.json",
            "pair_correlation_function_data.json"} <= written
    assert any(name.startswith("loss") and name.endswith("_data.json")
               for name in written)
    heat = json.loads((out / "frequency_heatmap_data.json").read_text())
    assert np.asarray(heat["histogram"]).sum() == 400 * 3
    jmodel = jax_build_flow(3, 2, 5.0, K=2, hidden_units=16, num_bins=4)
    tree = jmodel.load(str(out / "trained_model.pkl"))
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(
                jmodel.init_params(jax.random.key(0))))
