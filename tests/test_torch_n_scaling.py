"""The port's N-scaling tool (``flowstate_tpu_torch.tools.n_scaling``)
against the JAX tool ``tools/n_scaling.py``.

The issue-rate probe K3: the JAX tool's ``calibrate_vpu_ops`` runs its
Pallas kernel in interpret mode at iters 4, depth 2 and widths (2, 3) on
``ones((8, 128))``; its outputs f(x) and f(f(f(x))), caught through the
tool's ``_sync``, are held against ``issue_rate_plain`` to rtol 1e-6.  Both
round the multiply and the add separately in float32, so they agree to the
bit here.  The CUDA kernel fuses them (FFMA); the plain version's
``fused`` form, which ``chip_smoke.py`` phase 9 holds the kernel against on
the card, is held here against a correctly rounded FMA in exact rational
arithmetic.  Then the wrapper's checks, the chain-count rule, the op
counts, and the tool end to end on the CPU.
"""

import functools
import importlib.util
from fractions import Fraction
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flowstate_tpu.mcmc.pallas_metropolis import _pick_c_blk
from flowstate_tpu.utils import profiling
from flowstate_tpu_torch.tools import n_scaling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = [8, 32, 128, 512, 1024]


@pytest.fixture
def jax_tool(monkeypatch):
    """``tools/n_scaling.py`` loaded by path, its Pallas calls in interpret
    mode, without the persistent compilation cache it turns on."""
    monkeypatch.setattr(profiling, "enable_compilation_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_n_scaling", os.path.join(REPO, "tools", "n_scaling.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return tool


def test_issue_rate_plain_matches_the_jax_probe(jax_tool, monkeypatch):
    caught = []
    monkeypatch.setattr(jax_tool, "_sync",
                        lambda y: caught.append(np.asarray(y)))
    jax_tool.calibrate_vpu_ops(iters=4, depth=2, widths=(2, 3))
    assert len(caught) == 4          # f(x), then f(f(f(x))), per width
    x = torch.ones((1, 8, 128))
    for n_acc, once, thrice in ((2, *caught[:2]), (3, *caught[2:])):
        f = functools.partial(n_scaling.issue_rate_plain, n_acc=n_acc,
                              depth=2, iters=4)
        np.testing.assert_allclose(f(x)[0].numpy(), once, rtol=1e-6)
        np.testing.assert_allclose(f(f(f(x)))[0].numpy(), thrice, rtol=1e-6)


def test_issue_rate_wrapper_checks_its_input():
    x = torch.ones((2, 8, 128))
    before = n_scaling.LAUNCHES
    bad = [((torch.ones((8, 128)), 16, 8, 4), "B, 8, 128"),
           ((torch.ones((2, 8, 64)), 16, 8, 4), "B, 8, 128"),
           ((torch.ones((0, 8, 128)), 16, 8, 4), "B >= 1"),
           ((x.double(), 16, 8, 4), "float32"),
           ((x.transpose(0, 1).contiguous().transpose(0, 1), 16, 8, 4),
            "contiguous"),
           ((x, 0, 8, 4), "positive"), ((x, 16, 0, 4), "positive"),
           ((x, 16, 8, -1), "iters"),
           ((torch.ones((2, 8, 128), device="meta"), 16, 8, 4), "meta")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            n_scaling.issue_rate_kernel(*args)
    # a CPU tensor goes to the plain version, at any width and depth;
    # nothing is launched
    np.testing.assert_array_equal(
        n_scaling.issue_rate_kernel(x, 3, 2, 4).numpy(),
        n_scaling.issue_rate_plain(x, 3, 2, 4).numpy())
    assert n_scaling.LAUNCHES == before
    # on the card, only the compiled widths and depth
    for n_acc, depth, match in ((5, 8, "n_acc"), (16, 3, "depth")):
        with pytest.raises(ValueError, match=match + ".* on the card"):
            n_scaling._check_instance(n_acc, depth)
    for n_acc in n_scaling.ISSUE_RATE_WIDTHS:
        n_scaling._check_instance(n_acc, n_scaling.ISSUE_RATE_DEPTH)


def _nearest_float32(v: Fraction) -> np.float32:
    """``v`` rounded once to the nearest float32, ties to even."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(c.view(np.int32)) & 1))


def test_issue_rate_plain_fused_is_a_correctly_rounded_fma():
    n_acc, depth, iters = 3, 2, 2
    rng = np.random.default_rng(5)
    x = rng.random((1, 8, 128), dtype=np.float32)
    got = n_scaling.issue_rate_plain(torch.as_tensor(x), n_acc, depth, iters,
                                     fused=True)[0].numpy().ravel()
    add = Fraction(float(np.float32(1e-7)))
    cs = [Fraction(float(np.float32(1.0 + 1e-7 * (i + 1))))
          for i in range(n_acc)]
    for e in range(0, x.size, 17):
        out = np.float32(0.0)
        for i in range(n_acc):
            a = np.float32(x.ravel()[e] + np.float32(i))
            for _ in range(iters * depth):
                a = _nearest_float32(Fraction(float(a)) * cs[i] + add)
            out = a if i == 0 else np.float32(out + a)
        assert got[e] == out, (e, got[e], out)


def test_issue_rate_widths_are_the_instances_of_the_cuda_source():
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc",
                           "issue_rate.cu")) as f:
        src = f.read()
    widths = re.findall(r"case (\d+): return launch<(\d+)>", src)
    depth = re.findall(r"constexpr int kDepth = (\d+);", src)
    assert all(a == b for a, b in widths)
    assert tuple(int(a) for a, _ in widths) == n_scaling.ISSUE_RATE_WIDTHS
    assert [int(d) for d in depth] == [n_scaling.ISSUE_RATE_DEPTH]
    # the JAX tool's widths and depth (tools/n_scaling.py defaults)
    assert n_scaling.ISSUE_RATE_WIDTHS == (16, 32, 64, 128)
    assert n_scaling.ISSUE_RATE_DEPTH == 8


def test_chain_counts_follow_the_jax_rule():
    assert [n_scaling.chains_for(n) for n in NS] == [6144, 2048, 512, 512,
                                                     512]
    for n in NS + [3, 12, 100, 300]:
        rows = (n + 7) // 8 * 8
        assert n_scaling.c_blk(rows) == _pick_c_blk(rows)
        assert n_scaling.chains_for(n) == max(4 * _pick_c_blk(rows),
                                              (49152 // n + 127) // 128 * 128)
    with open(os.path.join(REPO, "results", "evidence",
                           "n_scaling_data.json")) as f:
        reference = json.load(f)["rows"]
    assert [(r["n"], r["chains"]) for r in reference] == [
        (n, n_scaling.chains_for(n)) for n in NS]


def test_op_counts_and_bounds():
    k = n_scaling
    assert k.k1_ops_per_move(3, 2) == 2 * 2 * 22 + 2 * 2 * 22 + 18
    assert k.k1_ops_per_move(1024, 0) == 2 * 1023 * 22 + 18
    ms, by = k.k1_bound(128, 1024, 0, 200)
    assert by == "operations"
    np.testing.assert_allclose(ms, 1e3 * 128 * 200 * 45030 / 67e12)
    # K3 at the check size: 65,536 operations per element, 8 bytes
    ms, by = k.k3_bound(4 * 1024, 16, 8, 256)
    assert by == "operations"
    np.testing.assert_allclose(ms, 1e3 * 4 * 1024 * 65536 / 67e12)
    ms, by = k.k3_bound(1024, 2, 2, 0)
    assert by == "bytes"
    ms, by = k.k2_bound(128, 1024, 0)
    np.testing.assert_allclose(ms, 1e3 * 128 * 1024 * 1023 // 2 * 26 / 67e12)


@pytest.mark.parametrize("c,n,wells", [(128, 1024, 0), (100, 3, 2),
                                       (4, 4096, 1)])
def test_k2_bound_charges_lj_work_for_pairs_inside_the_cutoff_only(c, n,
                                                                   wells):
    pairs = c * (n * (n - 1) // 2)
    wells_ops = c * n * wells * n_scaling.K2_WELL_FLOPS
    bytes_ms = 1e3 * c * (n * 8 + 8) / 3.35e12
    # every pair inside: the count before the skip, 26 per pair
    every, by = n_scaling.k2_bound(c, n, wells, pairs_inside=pairs)
    assert (every, by) == n_scaling.k2_bound(c, n, wells)
    np.testing.assert_allclose(
        every, max(1e3 * (pairs * 26 + wells_ops) / 67e12, bytes_ms))
    # a few pairs inside: their LJ terms, and the distance of every pair
    inside = pairs // 200
    few, _ = n_scaling.k2_bound(c, n, wells, pairs_inside=inside)
    np.testing.assert_allclose(
        few, max(1e3 * (pairs * 13 + inside * 13 + wells_ops) / 67e12,
                 bytes_ms))
    assert few < every or by == "bytes"


def test_calibration_prints_and_returns_each_width(capsys):
    rates = n_scaling.calibrate_fp32_ops(iters=3, depth=2, widths=(2, 3),
                                         device="cpu")
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [line["calibrate_n_acc"] for line in lines] == [2, 3]
    assert [line["ops_per_s"] for line in lines] == [rates[2], rates[3]]
    assert [line["tiles"] for line in lines] == [1, 1]
    assert all(np.isfinite(v) and v > 0 for v in rates.values())


def test_n_scaling_on_the_cpu_writes_finite_rows(tmp_path, monkeypatch):
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.ops import cuda_pair

    # the plain probe at the card's 65,536 iterations would take minutes
    monkeypatch.setattr(n_scaling, "calibrate_fp32_ops", functools.partial(
        n_scaling.calibrate_fp32_ops, iters=4))
    out = tmp_path / "n_scaling.json"
    before = (cm.LAUNCHES, cuda_pair.LAUNCHES, n_scaling.LAUNCHES)
    result = n_scaling.main(["--ns", "8", "16", "--moves", "4", "--repeats",
                             "1", "--plain_moves", "2", "--device", "cpu",
                             "--out", str(out)])
    assert (cm.LAUNCHES, cuda_pair.LAUNCHES, n_scaling.LAUNCHES) == before
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(result))
    assert saved["device"] == {"name": "cpu", "power_limit": None}
    assert "plain engine on the CPU" in saved["engine"]
    rows = saved["rows"]
    assert [(r["n"], r["chains"], r["moves_per_call"]) for r in rows] == [
        (8, 6144, 128), (16, 3072, 64)]
    for r in rows:
        for key in ("plain_moves_per_s", "kernel_moves_per_s",
                    "kernel_fast_moves_per_s", "speedup", "row_elems_per_s",
                    "frac_of_roof"):
            assert np.isfinite(r[key]) and r[key] > 0, (key, r)
        assert r["ops_per_move"] == n_scaling.k1_ops_per_move(r["n"], 0)
        assert r["threads_per_chain"] == cm.group_threads(r["n"]) == 8


def test_n_scaling_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        n_scaling.main(["--out", str(tmp_path / "x.json")])
    with pytest.raises(ValueError, match="--ns"):
        n_scaling.main(["--ns", "2048", "--device", "cpu"])
    assert not any(tmp_path.iterdir())


def test_n_scaling_imports_without_nvcc_and_builds_nothing():
    code = ("import sys, flowstate_tpu_torch.tools.n_scaling as m; "
            "b = sys.modules.get('flowstate_tpu_torch.kernels.build'); "
            "ok = m.LAUNCHES == 0 and (b is None or b._LOADED is None); "
            "sys.exit(0 if ok else 1)")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": os.path.join(REPO, "no-such-cuda")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_pairs_inside_cutoff_counts_min_image_pairs_within_reach():
    from flowstate_tpu_torch.ops import Box, SystemSpec

    rng = np.random.default_rng(3)
    box = Box(9.0, 7.0)
    pos = rng.uniform(0, 1, size=(5, 40, 2)) * [9.0, 7.0]
    spec = SystemSpec.create(40, box)
    d = pos[:, :, None] - pos[:, None]
    d -= np.array([9.0, 7.0]) * np.round(d / [9.0, 7.0])
    r2 = (d ** 2).sum(-1)
    want = sum(int((r2[c][np.triu_indices(40, 1)] <= 2.5 ** 2).sum())
               for c in range(5))
    assert 0 < want < 5 * 40 * 39 // 2
    got = n_scaling.pairs_inside_cutoff(spec, torch.as_tensor(
        pos, dtype=torch.float32))
    assert abs(got - want) <= 2   # float32 against float64 at the cutoff
