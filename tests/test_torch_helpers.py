"""The helpers of ``ops``, ``training``, ``utils`` and ``analysis`` that
the port keeps beside the main path, against the JAX package's.

Every public name the JAX subpackages export is exported by the port's
(less what ROADMAP's "Not to port" lists), and each helper's output
equals JAX's on the same seeded numpy inputs: float64 to 1e-12 (the same
formulas; ``squared_norm`` rounds the sum as XLA's fused multiply-add
does), JSON files byte for byte, the colour data exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowstate_tpu.analysis as janalysis
import flowstate_tpu.experiments as jexperiments
import flowstate_tpu.flows as jflows
import flowstate_tpu.io as jio
import flowstate_tpu.mcmc as jmcmc
import flowstate_tpu.ops as jops
import flowstate_tpu.parallel as jparallel
import flowstate_tpu.training as jtraining
import flowstate_tpu.utils as jutils
from flowstate_tpu.analysis import plots as jplots
from flowstate_tpu.utils import logging as jlogging
import flowstate_tpu_torch.analysis as tanalysis
import flowstate_tpu_torch.experiments as texperiments
import flowstate_tpu_torch.flows as tflows
import flowstate_tpu_torch.io as tio
import flowstate_tpu_torch.mcmc as tmcmc
import flowstate_tpu_torch.ops as tops
import flowstate_tpu_torch.parallel as tparallel
import flowstate_tpu_torch.training as ttraining
import flowstate_tpu_torch.utils as tutils
from flowstate_tpu_torch.analysis import plots as tplots
from flowstate_tpu_torch.utils import logging as tlogging
from flowstate_tpu_torch.utils.profiling import PhaseTimer, annotate, trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(rtol=1e-12, atol=1e-12)
# float32 well potentials of order 1: a few float32 ulps
WELLS_F32 = dict(rtol=1e-6, atol=1e-6)
# Names with no port, each for the reason ROADMAP's "Not to port" gives:
NOT_PORTED = {
    # the XLA compilation cache
    "enable_compilation_cache",
    # the one-hot block select; the port's gather and scatter are
    # bit-equal to it (PR 9)
    "random_block_onehots",
    # JAX sharding constructs with no torch.distributed counterpart: the
    # named mesh axis, and shard_map of a function over the global array
    # (a rank's process holds only its rows and calls the batched
    # function on them)
    "CHAIN_AXIS", "sharded_chain_fn",
}
# JAX name -> the port's counterpart under another name
RENAMED = {
    # the Pallas move kernel's wrappers -> the CUDA kernel's
    "run_moves_pallas": "run_moves_kernel",
    "run_production_pallas": "run_production_kernel",
    # a NamedSharding of the chain axis -> the rows a rank keeps; the
    # replicated sharding -> the broadcast that replicates a module
    "chain_sharding": "shard_rows",
    "replicated_sharding": "replicate",
}


@pytest.mark.parametrize("jax_pkg,port_pkg", [
    (jops, tops), (jutils, tutils), (janalysis, tanalysis),
    (jtraining, ttraining), (jflows, tflows), (jmcmc, tmcmc),
    (jparallel, tparallel), (jio, tio), (jexperiments, texperiments)],
    ids=["ops", "utils", "analysis", "training", "flows", "mcmc",
         "parallel", "io", "experiments"])
def test_port_exports_the_jax_packages_public_names(jax_pkg, port_pkg):
    names = set(jax_pkg.__all__) - NOT_PORTED
    missing = {n for n in names - set(port_pkg.__all__)
               if RENAMED.get(n) not in port_pkg.__all__}
    assert not missing, sorted(missing)
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None, name


def test_new_helper_modules_import_no_jax_or_matplotlib():
    code = ("import sys, flowstate_tpu_torch.ops, flowstate_tpu_torch.utils, "
            "flowstate_tpu_torch.utils.profiling, "
            "flowstate_tpu_torch.analysis, flowstate_tpu_torch.training, "
            "flowstate_tpu_torch.flows.nets; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flowstate_tpu', 'matplotlib'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----- ops/box.py ------------------------------------------------------------

def configuration(seed, n=9):
    box = jops.Box.from_density(n, 0.3)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 2)) * [box.size_x, box.size_y]
    return box, tops.Box(box.size_x, box.size_y), pos


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_box_helpers_match_jax(dtype):
    jbox, tbox, pos = configuration(1)
    pos = pos.astype(dtype)
    other = configuration(2)[2].astype(dtype)
    tol = TIGHT if dtype == np.float64 else dict(rtol=1e-6, atol=1e-6)
    t = torch.as_tensor
    with jax.enable_x64(dtype == np.float64):
        j = jnp.asarray
        pairs = [
            (jops.min_image_centered(j(pos - 3.0), 2.5),
             tops.min_image_centered(t(pos - 3.0), 2.5)),
            (jops.distance(j(pos), j(other), jbox),
             tops.distance(t(pos), t(other), tbox)),
            (jops.distances_to_all(j(pos[0]), j(other), jbox),
             tops.distances_to_all(t(pos[0]), t(other), tbox)),
            (jops.pair_distance_matrix(j(pos), jbox),
             tops.pair_distance_matrix(t(pos), tbox)),
            (jops.upper_triangle_distances(j(pos), jbox),
             tops.upper_triangle_distances(t(pos), tbox)),
        ]
    for want, got in pairs:
        assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_pair_distance_matrix_has_zero_gradient_on_its_diagonal():
    _, tbox, pos = configuration(3, n=4)
    x = torch.tensor(pos, requires_grad=True)
    d = tops.pair_distance_matrix(x, tbox)
    assert torch.equal(torch.diagonal(d), torch.zeros(4, dtype=x.dtype))
    d.sum().backward()
    assert bool(torch.isfinite(x.grad).all())


# ----- ops/potentials.py -----------------------------------------------------

def test_potential_helpers_match_jax():
    """The LJ force in float64 to 1e-12.  The wells in float32, the
    drivers' dtype, to ``WELLS_F32``: JAX keeps the well centers in float32
    whatever the positions' dtype (``ops/potentials.py:119``), so a float64
    comparison would measure that rounding (2e-7 here), and float32 tanh
    and exp differ between XLA and torch in the last bits."""
    assert tops.DEFAULT_V0_LIST == jops.DEFAULT_V0_LIST
    rng = np.random.default_rng(4)
    r = np.concatenate([[0.0, 1e-13, 0.5, 1.0, 2.5, 2.5000001, 3.0],
                        rng.uniform(0.3, 3.0, 50)])
    with jax.enable_x64(True):
        pairs = [(jops.lennard_jones_force(jnp.asarray(r)),
                  tops.lennard_jones_force(torch.as_tensor(r))),
                 (jops.lennard_jones_force(jnp.asarray(r), 0.7, 1.3, 2.0),
                  tops.lennard_jones_force(torch.as_tensor(r), 0.7, 1.3, 2.0))]
    for want, got in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)

    jbox, _, pos = configuration(5, n=16)
    pos = pos.astype(np.float32)
    lx, ly = jbox.size_x, jbox.size_y
    pairs = []
    for kw in ({}, dict(V0=-3.0, r0=1.2, k=15.0, num_wells=1)):
        pairs.append((
            jops.double_well_potential_equal(jnp.asarray(pos), lx, ly,
                                             **kw),
            tops.double_well_potential_equal(torch.as_tensor(pos), lx,
                                             ly, **kw)))
    for kw in ({}, dict(V0=-1.5, a=2.0, num_wells=1)):
        pairs.append((
            jops.gaussian_double_well(jnp.asarray(pos), lx, ly, **kw),
            tops.gaussian_double_well(torch.as_tensor(pos), lx, ly,
                                      **kw)))
    # one position: a scalar, as JAX's squeeze gives
    pairs.append((jops.gaussian_double_well(jnp.asarray(pos[0]), lx, ly),
                  tops.gaussian_double_well(torch.as_tensor(pos[0]),
                                            lx, ly)))
    for want, got in pairs:
        assert tuple(got.shape) == np.shape(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WELLS_F32)


# ----- training, utils -------------------------------------------------------

def test_train_state_has_jaxs_fields():
    assert ttraining.TrainState._fields == jtraining.TrainState._fields
    g = torch.Generator().manual_seed(0)
    s = ttraining.TrainState({"w": torch.zeros(2)}, None, g)
    assert s.key is g and s._replace(opt_state=1).opt_state == 1


def test_save_params_json_writes_jaxs_file(tmp_path):
    params = {"K": 15, "rho": np.float32(0.03), "n": np.int64(3),
              "V0": np.array([-10.0, -10.5]), "name": "a1",
              "nested": {"x": np.float64(1.5)}}
    jpath = jlogging.save_params_json(params, str(tmp_path / "jax"))
    tpath = tlogging.save_params_json(params, str(tmp_path / "port" / "new"))
    assert os.path.basename(tpath) == "params.json"
    with open(jpath) as f, open(tpath) as g:
        assert f.read() == g.read()
    # tensors, on any device, as numbers and lists
    tlogging.save_params_json({"t": torch.tensor([1.0, 2.0]),
                               "s": torch.tensor(3)}, str(tmp_path), "t.json")
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == {"t": [1.0, 2.0], "s": 3}


def test_profiling_hooks(tmp_path):
    class Metrics:
        def __init__(self):
            self.events = []

        def log(self, event, **fields):
            self.events.append((event, fields))

    metrics = Metrics()
    timer = PhaseTimer(metrics)
    with trace(str(tmp_path)) as prof:
        for _ in range(2):
            with timer.phase("step", sync_on=torch.ones(3)):
                with annotate("flowstate_step"):
                    torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "flowstate_step" in names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    summary = timer.summary()
    assert summary["step"]["count"] == 2
    assert summary["step"]["total_s"] >= summary["step"]["mean_s"] > 0
    assert [e for e, _ in metrics.events] == ["phase_time"] * 2
    assert set(summary) == set(jutils.PhaseTimer().summary()) | {"step"}


# ----- analysis/plots.py: the ICL style --------------------------------------

def test_icl_colours_and_maps_match_jax():
    import matplotlib

    assert tplots.ICL_COLOR_CYCLE == jplots.ICL_COLOR_CYCLE
    for kind in ("sequential", "diverging", "multistep"):
        a = jplots.get_icl_heatmap_cmap(kind)
        b = tplots.get_icl_heatmap_cmap(kind)
        assert a.name == b.name
        grid = np.linspace(0.0, 1.0, 33)
        np.testing.assert_array_equal(a(grid), b(grid))
    for fn in (jplots.get_icl_heatmap_cmap, tplots.get_icl_heatmap_cmap):
        with pytest.raises(ValueError, match="cmap_type"):
            fn("rainbow")
    keys = ("axes.prop_cycle", "text.usetex", "font.family", "font.serif",
            "figure.dpi", "savefig.dpi", "savefig.format")
    with matplotlib.rc_context():
        jplots.set_icl_color_cycle()
        want = {k: matplotlib.rcParams[k] for k in keys}
    with matplotlib.rc_context():
        tplots.set_icl_color_cycle()
        got = {k: matplotlib.rcParams[k] for k in keys}
    assert got == want


def test_icl_helpers_without_matplotlib(monkeypatch):
    """The card's machine has no matplotlib: the style helpers then do
    nothing and give no colormap, and still refuse an unknown one."""
    monkeypatch.setattr(tplots, "_pyplot", lambda: None)
    assert tplots.set_icl_color_cycle() is None
    assert tplots.get_icl_heatmap_cmap("diverging") is None
    with pytest.raises(ValueError, match="cmap_type"):
        tplots.get_icl_heatmap_cmap("rainbow")
