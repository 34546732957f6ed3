"""The port's demos and their notebooks.

Each demo of ``flowstate_tpu_torch/demos`` runs at its smoke size on the
CPU and writes the files ``tests/test_demos.py`` requires of its JAX
twin; without a device argument it asks for the card, which this host
lacks.  The committed notebooks are valid nbformat-4 JSON and equal to
what ``tools.make_notebooks`` writes from the demos now.
"""

import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

from flowstate_tpu_torch.tools import make_notebooks

torch.set_num_threads(1)

DEMOS = ("mcmc_demo", "hybrid_algorithm_1_demo", "hybrid_algorithm_2_demo",
         "nf_demo", "tempering_demo")


def demo(name):
    return importlib.import_module(f"flowstate_tpu_torch.demos.{name}")


def test_mcmc_demo_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = demo("mcmc_demo").main(smoke=True, device="cpu")
    assert "delta_f_mean" in results or "directory" in results
    out = tmp_path / "demo_results" / "mcmc_demo"
    assert (out / "params.json").exists()
    assert (out / "metrics.jsonl").exists()


@pytest.mark.parametrize("name,run_id", [("hybrid_algorithm_1_demo",
                                          "a1_demo"),
                                         ("hybrid_algorithm_2_demo",
                                          "a2_demo")])
def test_hybrid_demos_smoke(tmp_path, monkeypatch, name, run_id):
    monkeypatch.chdir(tmp_path)
    results = demo(name).main(smoke=True, device="cpu")
    assert results is not None
    assert (tmp_path / "demo_results" / run_id / "params.json").exists()


def test_nf_demo_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loss_epoch = demo("nf_demo").main(smoke=True, device="cpu")
    assert np.isfinite(loss_epoch).all()
    out = tmp_path / "demo_results" / "nf_demo"
    assert (out / "loss_plot_data.json").exists()
    assert (out / "frequency_heatmap_data.json").exists()


def test_tempering_demo_smoke(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert np.isfinite(demo("tempering_demo").main(smoke=True, device="cpu"))


def test_demos_ask_for_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        demo("tempering_demo").main(smoke=True)
    for name in DEMOS:
        default = ast.parse(open(demo(name).__file__).read())
        main = next(n for n in default.body
                    if isinstance(n, ast.FunctionDef) and n.name == "main")
        assert [a.arg for a in main.args.args] == ["smoke", "device"]
        assert [ast.literal_eval(d) for d in main.args.defaults] == [False,
                                                                    "cuda"]


def test_notebooks_exist_and_are_valid():
    scripts = make_notebooks.demo_scripts()
    assert [s[:-3] for s in scripts] == sorted(DEMOS)
    for script in scripts:
        path = make_notebooks.notebook_path(script)
        assert os.path.exists(path), f"missing notebook for {script}"
        nb = json.load(open(path))
        assert nb["nbformat"] == 4
        kinds = [c["cell_type"] for c in nb["cells"]]
        assert kinds[0] == "markdown" and "code" in kinds
        for cell in nb["cells"]:
            if cell["cell_type"] == "code":
                ast.parse("".join(cell["source"]))


def test_notebooks_in_sync_with_demos():
    for script in make_notebooks.demo_scripts():
        regenerated = make_notebooks.make_notebook(
            os.path.join(make_notebooks.DEMO_DIR, script))
        committed = json.load(open(make_notebooks.notebook_path(script)))
        assert regenerated == committed, (
            f"{script}: notebook out of sync; run python -m "
            "flowstate_tpu_torch.tools.make_notebooks")
