"""The port's N-scaling studies against the JAX package's tools.

* The helpers: ``ess_fields`` equal to JAX's ``_ess_fields``;
  ``resuppress`` rewriting a JSON as JAX's does; ``hybrid_summary`` equal
  to the ten lines the JAX tools write inline, built from JAX's
  ``multichain_ess`` and ``crossing_bound_ess`` (1e-12); ``split_acceptance``
  on a stub flow that gives both the same proposals and log q (the accept
  flags equal except within ``NEAR_TIE`` of a tie, ROADMAP R2; the MH
  log-ratios to 1e-5 relative); ``make_context`` at N=8, k = 1-3, both
  kinds, in float32 to 1e-6.
* The constants (``RUNGS`` read from the JAX tool's ``main`` by ``ast``,
  ``BENCH_CHAINS``, ``ROUNDS_PER_CALL``, ``BIG_CALLS``) and each tool's
  argparse defaults (read by ``ast``) equal JAX's, bar ``json_out``,
  ``device``, ``seed`` and ``evidence``.
* Each tool's ``main`` at a tiny size on the CPU: every key the JAX
  tool's source gives its result dicts; n_mitigation's merge of two
  invocations into one evidence file, against the JAX tool's own merge
  block run on the same rows.

The JAX tools are imported from the repository's ``tools/`` as
``tests/test_torch_tools.py`` imports them; the port never imports them.
"""

import ast
import copy
import json
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import ops as jops
from flowstate_tpu.analysis.ess import (
    crossing_bound_ess as j_crossing_bound_ess,
    multichain_ess as j_multichain_ess,
)
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch.tools import (
    alpha_study, blocked_depth, blocked_wall, common, hybrid_n_scaling,
    n_mitigation,
)
from flowstate_tpu_torch.tools.common import double_well_spec
from test_torch_blocked import onehots, perms, positions

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
NEAR_TIE = 1e-5
TIGHT = dict(rtol=1e-12, atol=1e-12)
PORT_ONLY = {"device", "seed", "evidence"}
JAX_ONLY = {"json_out"}
STUDIES = {"hybrid_n_scaling": hybrid_n_scaling,
           "n_mitigation": n_mitigation, "blocked_wall": blocked_wall,
           "blocked_depth": blocked_depth, "alpha_study": alpha_study}


@pytest.fixture(scope="module")
def jtools():
    """The JAX package's study tools as modules (imported with JAX's
    persistent compilation cache, which they switch on, left off)."""
    from flowstate_tpu.utils import profiling

    enable = profiling.enable_compilation_cache
    profiling.enable_compilation_cache = lambda *args, **kwargs: None
    sys.path.insert(0, TOOLS)
    try:
        import alpha_study as jalpha
        import blocked_depth as jdepth
        import blocked_wall as jwall
        import hybrid_n_scaling as jhybrid
        import n_mitigation as jmit
    finally:
        sys.path.remove(TOOLS)
        profiling.enable_compilation_cache = enable
    return dict(hybrid_n_scaling=jhybrid, n_mitigation=jmit,
                blocked_wall=jwall, blocked_depth=jdepth,
                alpha_study=jalpha)


def jax_source(tool: str) -> ast.Module:
    with open(os.path.join(TOOLS, f"{tool}.py")) as f:
        return ast.parse(f.read())


def jax_function(tool: str, name: str) -> ast.FunctionDef:
    return next(n for n in ast.walk(jax_source(tool))
                if isinstance(n, ast.FunctionDef) and n.name == name)


def dict_keys(node: ast.Dict) -> set:
    """The constant keys of a dict literal, with those of a
    ``**{k: ... for k in (...)}`` inside it."""
    keys = set()
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            keys.add(k.value)
        elif (k is None and isinstance(v, ast.DictComp)
              and isinstance(v.generators[0].iter, ast.Tuple)):
            keys |= {e.value for e in v.generators[0].iter.elts}
    return keys


def jax_keys(tool: str, func: str, target: str) -> set:
    """The constant keys that ``func`` of the JAX tool gives the dict
    written ``target`` in its source (``out``, ``out['pt']``): its dict
    literal, the literals it is ``update``d or ``append``ed with, and its
    subscript assignments."""
    keys = set()
    for node in ast.walk(jax_function(tool, func)):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if ast.unparse(t) == target and isinstance(node.value,
                                                           ast.Dict):
                    keys |= dict_keys(node.value)
                if (isinstance(t, ast.Subscript)
                        and ast.unparse(t.value) == target
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("update", "append")
                and ast.unparse(node.func.value) == target):
            for a in node.args:
                if isinstance(a, ast.Dict):
                    keys |= dict_keys(a)
    assert keys, f"no keys of {target} in {tool}.{func}"
    return keys


def ess_keys() -> set:
    """The fields ``_ess_fields`` always gives (the suppressed estimate
    only when the estimate is unreliable)."""
    return jax_keys("hybrid_n_scaling", "_ess_fields", "out") - {
        "well_ess_suppressed_estimate"}


# ----- the helpers -----------------------------------------------------------

@pytest.mark.parametrize("args", [(812.4567, 2300.2, 3.7, True),
                                  (812.4567, 300.25, 0.41, False),
                                  (0.0, 6.4, 1.0, False)])
def test_ess_fields_equal_jax(jtools, args):
    assert (common.ess_fields(*args)
            == jtools["hybrid_n_scaling"]._ess_fields(*args))


def test_resuppress_rewrites_the_json_as_jax(jtools, tmp_path, capsys):
    doc = {"metric": "hybrid_n_scaling", "systems": [
        {"n": 8, "local_trained": {
            "well_ess": 518.0, "well_ess_per_s": 959.26,
            "well_ess_upper_bound": 75.3, "ess_reliable": False,
            "wall_s": 0.54, "crossings": 62},
         "pt_trained": {"well_ess": 12.5, "well_ess_upper_bound": 80.0,
                        "ess_reliable": True, "wall_s": 2.0}},
        {"n": 16, "local_trained": {
            "well_ess": None, "well_ess_suppressed_estimate": 41.7,
            "well_ess_upper_bound": 9.1, "ess_reliable": False},
         "pt_trained": None}]}
    texts = []
    for fn in (jtools["hybrid_n_scaling"].resuppress,
               hybrid_n_scaling.resuppress):
        path = tmp_path / f"{len(texts)}.json"
        path.write_text(json.dumps(doc))
        fn(str(path))
        texts.append(path.read_text())
    assert texts[0] == texts[1]
    assert json.loads(texts[1])["systems"][0]["local_trained"][
        "well_ess"] is None
    out = capsys.readouterr().out
    assert out.count("resuppressed unreliable ESS fields") == 2


def jax_inline_summary(jtools, w, n_a, n_b, dt, df_pt):
    """``tools/hybrid_n_scaling.py:267-281`` as JAX writes it: ``w`` is
    the scan's (T, C) labels, the counts (T, C)."""
    rounds = w.shape[0]
    var = {}
    burn = rounds // 3
    w = np.asarray(w).T
    ess = j_multichain_ess(w[:, burn:])
    ess_ub = j_crossing_bound_ess(w[:, burn:])
    crossings = int(np.sum(np.abs(np.diff(w, axis=1)) > 0.5))
    df = float(np.log(max(n_b[burn:].sum(), 1.0)
                      / max(n_a[burn:].sum(), 1.0)))
    reliable = crossings >= 20 and ess <= ess_ub
    var.update(jtools["hybrid_n_scaling"]._ess_fields(
        float(ess), float(ess_ub), dt, reliable))
    var.update({
        "wall_s": round(dt, 2), "crossings": crossings,
        "df_particle": round(df, 4),
        "df_vs_pt": round(df - df_pt, 4),
    })
    return var


@pytest.mark.parametrize("seed,c,t,p_flip", [(1, 16, 60, 0.05),
                                             (2, 40, 33, 0.002),
                                             (3, 8, 24, 0.3)])
def test_hybrid_summary_equals_jax_inline_arithmetic(jtools, seed, c, t,
                                                     p_flip):
    rng = np.random.default_rng(seed)
    flips = rng.random((c, t)) < p_flip
    w = (np.cumsum(flips, axis=1) + rng.integers(0, 2, (c, 1))) % 2
    w = w.astype(np.float32)                                  # (C, T)
    n_b = np.where(w > 0, rng.integers(5, 9, (c, t)),
                   rng.integers(0, 4, (c, t)))
    n_a = 8 - n_b - rng.integers(0, 2, (c, t))
    got = common.hybrid_summary(w, n_a, n_b, 1.37, 0.0546)
    want = jax_inline_summary(jtools, w.T, n_a.T, n_b.T, 1.37, 0.0546)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], **TIGHT)
        else:
            assert got[k] == want[k], k


class JaxStubFlow:
    """Proposals near the start (a fixed centred configuration plus noise
    from the key), log q from the key, and a smooth log q of a point."""

    def __init__(self, base):
        self.base = jnp.asarray(base)

    def sample_and_log_prob(self, params, key, c):
        k1, k2 = jax.random.split(key)
        noise = 0.08 * jax.random.normal(k1, self.base.shape)
        return self.base + noise, 0.5 * jax.random.normal(k2, (c,))

    def log_prob(self, params, x):
        return -0.02 * jnp.sum(x * x, axis=-1)


class TorchStubFlow:
    """JAX's stub's outputs for the generator's round (its seed less
    1000), and the same log q of a point."""

    device = torch.device("cpu")

    def __init__(self, draws):
        self.draws = draws

    def sample_and_log_prob(self, c, generator):
        x, lq = self.draws[generator.initial_seed() - 1000]
        return torch.as_tensor(x), torch.as_tensor(lq)

    def log_prob(self, x):
        return -0.02 * torch.sum(x * x, dim=-1)


def test_split_acceptance_equals_jax(jtools):
    n, c, rounds = 4, 64, 6
    jspec = jops.SystemSpec.create(n, jops.Box.from_density(n, 0.03),
                                   num_wells=2, V0_list=(-10.0, -10.5),
                                   r0=1.2, k=15.0)
    tspec = double_well_spec(n)
    half_box = tspec.box.size_x / 2
    pos, _ = tmcmc.init_split_wells(c, n, 0.03)
    rng = np.random.default_rng(4)
    pos = (pos + rng.normal(0, 0.15, pos.shape)).astype(np.float32)
    state = tmcmc.init_chain_state(tspec, torch.as_tensor(pos), 0)
    base = (pos - half_box).reshape(c, -1)
    jflow = JaxStubFlow(base)
    draws = [tuple(np.array(a) for a in jflow.sample_and_log_prob(
        None, jax.random.key(1000 + rd), c)) for rd in range(rounds)]
    jstate = types.SimpleNamespace(positions=jnp.asarray(pos),
                                   energy=jnp.asarray(state.energy.numpy()))
    j_acc, j_r = jtools["n_mitigation"].split_acceptance(
        jspec, 1.0, jflow, None, half_box, jstate, rounds)
    t_acc, t_r = n_mitigation.split_acceptance(
        tspec, 1.0, TorchStubFlow(draws), half_box, state, rounds)
    assert t_acc.dtype == np.float32 and t_acc.shape == (rounds, c)
    u = np.random.default_rng(7).uniform(size=(rounds, c))
    away = np.abs(np.exp(np.minimum(j_r, 0.0)) - u) >= NEAR_TIE
    np.testing.assert_array_equal(t_acc[away], np.asarray(j_acc)[away])
    np.testing.assert_allclose(t_r, j_r, rtol=1e-5, atol=1e-5)
    assert 0.05 < t_acc.mean() < 0.95


@pytest.mark.parametrize("context", ["fourier", "coords"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_make_context_equals_jax(jtools, context, k):
    n, b = 8, 37
    half_box = double_well_spec(n).box.size_x / 2
    args = types.SimpleNamespace(context=context, m_max=3)
    pos = positions(11 + k, b, n, 2 * half_box).astype(np.float32)
    perm = perms(12 + k, b, n)
    _, rest = onehots(perm, k)
    j_fn, j_dim = jtools["blocked_wall"].make_context(args, n, k, half_box)
    t_fn, t_dim = blocked_wall.make_context(args, n, k, half_box)
    assert t_dim == j_dim
    got = t_fn(torch.as_tensor(perm[:, k:]), torch.as_tensor(pos)).numpy()
    want = np.asarray(j_fn(jnp.asarray(rest), jnp.asarray(pos)))
    assert got.shape == want.shape == (b, j_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ----- the constants and the options -----------------------------------------

def rungs_of_jax() -> dict:
    """``RUNGS``, a dict of ``dict(...)`` calls in the JAX tool's main."""
    for node in ast.walk(jax_function("n_mitigation", "main")):
        if (isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "RUNGS"):
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no RUNGS in n_mitigation.main")


def test_constants_equal_jax(jtools):
    assert n_mitigation.RUNGS == rungs_of_jax()
    for name in ("BENCH_CHAINS", "ROUNDS_PER_CALL", "BIG_CALLS"):
        assert getattr(blocked_depth, name) == getattr(
            jtools["blocked_depth"], name)


def jax_defaults(tool: str) -> dict:
    """Each option of the JAX tool's ``main`` and its default, by ast."""
    out = {}
    for node in ast.walk(jax_function(tool, "main")):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            name = ast.literal_eval(node.args[0]).lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[name] = ast.literal_eval(kw["default"])
            elif ("action" in kw
                  and ast.literal_eval(kw["action"]) == "store_true"):
                out[name] = False
            else:
                out[name] = None
    return out


@pytest.mark.parametrize("tool", list(STUDIES))
def test_argparse_defaults_equal_jax(tool):
    want = jax_defaults(tool)
    got = vars(STUDIES[tool].make_parser().parse_args([]))
    assert set(got) - PORT_ONLY == set(want) - JAX_ONLY
    for k in set(want) - JAX_ONLY:
        assert got[k] == want[k], k


# ----- the tools' entry points -----------------------------------------------

def cpu_run(module, argv, tmp_path, monkeypatch, name="evidence.json"):
    # the studies' fixed 20,000-move equilibration, cut to the tiny sizes
    monkeypatch.setattr(common, "SPLIT_EQUILIBRATION_MOVES", 300)
    monkeypatch.chdir(tmp_path)
    evidence = str(tmp_path / "out" / name)
    result = module.main(argv + ["--device", "cpu", "--evidence", evidence])
    with open(evidence) as f:
        assert json.load(f)
    return result


def finite(x) -> bool:
    return x is not None and math.isfinite(x)


TINY = ["--moves_per_round", "5", "--acc_rounds", "2", "--rounds", "12"]


def test_hybrid_n_scaling_main(tmp_path, monkeypatch):
    # N=4 starts in the wells, N=13 on the half-box lattices; 520 local
    # configurations train one step, the PT set (fewer than a batch) none
    res = cpu_run(hybrid_n_scaling, TINY + [
        "--n_list", "4,13", "--chains", "20", "--replicas", "2",
        "--collect_rounds", "26", "--pt_rounds", "12", "--epochs", "1",
        "--K", "2", "--hidden", "16", "--bins", "4"], tmp_path, monkeypatch)
    tool = "hybrid_n_scaling"
    assert jax_keys(tool, "main", "results") <= set(res)
    variant = jax_keys(tool, "hybrid_variant", "var") | ess_keys()
    assert [s["n"] for s in res["systems"]] == [4, 13]
    for s in res["systems"]:
        assert jax_keys(tool, "run_for_n", "out") <= set(s)
        assert jax_keys(tool, "run_for_n", "out['pt']") <= set(s["pt"])
        for tag in ("local_trained", "pt_trained"):
            assert variant <= set(s[tag])
            assert 0.0 <= s[tag]["big_move_acceptance"] <= 1.0
            assert finite(s[tag]["df_particle"])
        assert s["local_trained"]["train_configs"] == 520
        assert finite(s["local_trained"]["fkld_last"])
    # --resuppress rewrites the evidence in place, and runs nothing
    path = tmp_path / "out" / "evidence.json"
    assert hybrid_n_scaling.main(["--resuppress", "--evidence",
                                  str(path)]) is None


def test_n_mitigation_main_and_merge(jtools, tmp_path, monkeypatch):
    tiny = {k: dict(v, K=2, hidden=16, epochs=1)
            for k, v in n_mitigation.RUNGS.items()}
    monkeypatch.setattr(n_mitigation, "RUNGS", tiny)
    argv = ["--n", "4", "--chains", "8", "--collect_rounds", "3",
            "--moves_per_round", "5", "--acc_rounds", "2"]
    first = cpu_run(n_mitigation, argv + ["--rungs", "base,gnn"],
                    tmp_path, monkeypatch)
    second = cpu_run(n_mitigation, argv + ["--rungs", "gnn,transformer"],
                     tmp_path, monkeypatch)
    assert set(second) == {"metric", "systems"}
    system = second["systems"][0]
    # "systems": the merged document's key
    assert jax_keys("n_mitigation", "main", "out") - {"systems"} <= set(
        system)
    row_keys = jax_keys("n_mitigation", "main", "row")
    for row in first["systems"][0]["rows"] + system["rows"]:
        assert row_keys <= set(row), row
        assert 0.0 <= row["acceptance"] <= 1.0
    # the JAX tool's merge block on the first document and the second
    # invocation's own rows (the last two)
    system = dict(system, rows=system["rows"][-2:])
    merge_block = next(
        n for n in jax_function("n_mitigation", "main").body
        if isinstance(n, ast.If) and "os.path.exists(path)" in ast.unparse(
            n.test))
    path = tmp_path / "jax.json"
    path.write_text(json.dumps(first))
    scope = dict(os=os, json=json, path=str(path), n=4,
                 out=copy.deepcopy(system))
    exec(compile(ast.Module([merge_block], []), "n_mitigation", "exec"),
         scope)
    assert (common.finite_or_none(second)
            == common.finite_or_none(scope["out"]))
    assert [r["rung"] for r in second["systems"][0]["rows"]] == [
        "base", "gnn", "transformer"]


def test_blocked_wall_main(tmp_path, monkeypatch):
    # 10 walkers x 52 rounds after the burn: 520 PT configurations, one
    # batch of 512
    res = cpu_run(blocked_wall, TINY + [
        "--n_list", "4", "--k_list", "1,2,4", "--chains", "20",
        "--replicas", "2", "--pt_rounds", "78", "--epochs", "1", "--K", "2",
        "--hidden", "16", "--bins", "4"], tmp_path, monkeypatch)
    tool = "blocked_wall"
    assert jax_keys(tool, "main", "results") <= set(res)
    (s,) = res["systems"]
    assert jax_keys(tool, "run_for_n", "out") <= set(s)
    assert jax_keys(tool, "run_for_n", "out['pt']") <= set(s["pt"])
    row_keys = jax_keys(tool, "run_for_n", "row") | ess_keys()
    assert [r["k"] for r in s["blocks"]] == [1, 2]      # k < N only
    for row in s["blocks"]:
        assert row_keys <= set(row)
        assert 0.0 <= row["acceptance"] <= 1.0
        assert finite(row["loss_last"]) and finite(row["df_particle"])
        assert row["blocked_per_round"] == 4 // row["k"]


def test_blocked_depth_main(tmp_path, monkeypatch):
    monkeypatch.setattr(blocked_depth, "BENCH_CHAINS", 16)
    monkeypatch.setattr(blocked_depth, "ROUNDS_PER_CALL", 2)
    res = cpu_run(blocked_depth, TINY + [
        "--n", "4", "--K_list", "2,3", "--hidden_list", "16",
        "--chains", "8", "--replicas", "2", "--pt_rounds", "12",
        "--epochs", "1", "--bins", "4"], tmp_path, monkeypatch)
    tool = "blocked_depth"
    assert jax_keys(tool, "main", "out") <= set(res)
    row_keys = jax_keys(tool, "main", "row") | ess_keys()
    assert [(r["K"], r["hidden"]) for r in res["rows"]] == [(2, 16), (3, 16)]
    for row in res["rows"]:
        assert row_keys <= set(row)
        assert 0.0 <= row["acceptance"] <= 1.0
        assert row["blocked_moves_per_s"] > 0


A2_TINY = dict(K=2, hidden_units=16, num_bins=4, batch_size=8,
               update_num_samples=16, initial_training_num_samples=16,
               sampling_frequency=5, equilibration_steps=100,
               adjusting_frequency=100, num_samples_for_analysis=64)


def test_alpha_study_main(tmp_path, monkeypatch):
    preset = alpha_study.algorithm2_config
    monkeypatch.setattr(alpha_study, "algorithm2_config",
                        lambda **kw: preset(**{**kw, **A2_TINY}))
    res = cpu_run(alpha_study, ["--cycles", "2", "--chains", "4",
                                "--output_dir", "a2"], tmp_path, monkeypatch)
    # "lr_sweep_runs": only in the lr sweep's appended document
    assert jax_keys("alpha_study", "main", "out") - {"lr_sweep_runs"} <= set(
        res)
    run_keys = jax_keys("alpha_study", "main", "runs")
    assert [r["alpha"] for r in res["runs"]] == [1.0, 0.5]
    for run in res["runs"]:
        assert run_keys <= set(run)
        assert 0.0 <= run["big_move_acceptance_final"] <= 1.0
        assert all(finite(x) for x in run["loss_per_cycle"])
    # the lr sweep appends to the study in the evidence file
    evidence = str(tmp_path / "out" / "evidence.json")
    swept = alpha_study.main(["--cycles", "2", "--chains", "4",
                              "--output_dir", "a2", "--alphas", "0.5",
                              "--lr_list", "1e-3", "--device", "cpu",
                              "--evidence", evidence])
    assert [r["alpha"] for r in swept["runs"]] == [1.0, 0.5]
    assert [(r["alpha"], r["lr"]) for r in swept["lr_sweep_runs"]] == [
        (0.5, 1e-3)]
