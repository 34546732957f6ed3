"""Every module of the JAX package and every file of the repository's
``tools/`` has a counterpart in the port: a file at the same place in
``flowstate_tpu_torch/`` (``tools/x.py`` -> ``flowstate_tpu_torch/tools/
x.py``), a counterpart under another name (``RENAMED_MODULES``), or a
line of ``NOT_PORTED_MODULES`` that gives the reason.  The public names
of ``utils/roofs.py`` are held the same way, since ``roofs`` is not in
the JAX package's ``utils.__all__`` (``tests/test_torch_helpers.py``).
"""

import ast
import os

import pytest

from flowstate_tpu_torch.utils import roofs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT, TOOLS = "flowstate_tpu", "flowstate_tpu_torch", "tools"

# a JAX file -> the port's file of the same role under another name
RENAMED_MODULES = {
    # the Pallas move kernel's module -> K1's (csrc/metropolis_moves.cu)
    "flowstate_tpu/mcmc/pallas_metropolis.py":
        "flowstate_tpu_torch/mcmc/cuda_metropolis.py",
    # the Pallas pair-energy kernel's module -> K2's (csrc/pair_energy.cu)
    "flowstate_tpu/ops/pallas_pair.py": "flowstate_tpu_torch/ops/cuda_pair.py",
    # the Pallas kernel's statistics check -> K1's
    "tools/pallas_check.py": "flowstate_tpu_torch/tools/move_kernel_check.py",
}
# a JAX file the port does not need -> why
NOT_PORTED_MODULES = {
    "tools/probe_cblk.py":
        "times the Pallas kernel's chains per block (c_blk), a tiling "
        "parameter K1 does not have; K1's counterpart question, its group "
        "size by chain count, is ROADMAP queue 2 item 2",
    "tools/retile_probe.py":
        "times the Pallas kernel's sweep_chunk and c_blk retiling, which K1 "
        "does not have (queue 2 item 2, as probe_cblk.py)",
    "tools/parity_check.py":
        "loads the reference fork's checkout, which the repository does not "
        "hold (R5)",
    "tools/evidence_runs_r3.sh":
        "a shell script of JAX runs; the port runs the same with python -m "
        "flowstate_tpu_torch.experiments.algorithm2 --fused "
        "[--freeze_after 500] and flowstate_tpu_torch/tools/sector_check.py",
}


def jax_files() -> list:
    """The JAX package's .py files and every file of ``tools/``, as paths
    relative to the repository."""
    out = []
    for root, _, files in os.walk(os.path.join(REPO, JAX_PKG)):
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")]
    out += [os.path.join(TOOLS, f)
            for f in os.listdir(os.path.join(REPO, TOOLS))
            if os.path.isfile(os.path.join(REPO, TOOLS, f))]
    return sorted(out)


def counterpart(path: str) -> str:
    if path.startswith(JAX_PKG + os.sep):
        return PORT + path[len(JAX_PKG):]
    return os.path.join(PORT, path)


@pytest.mark.parametrize("path", jax_files())
def test_every_jax_module_and_tool_has_a_port_or_a_reason(path):
    if path in NOT_PORTED_MODULES:
        assert not os.path.exists(os.path.join(REPO, counterpart(path)))
        return
    port = RENAMED_MODULES.get(path, counterpart(path))
    assert os.path.isfile(os.path.join(REPO, port)), (
        f"{path} has no counterpart ({port}), no RENAMED_MODULES entry and "
        f"no NOT_PORTED_MODULES reason")


def test_the_maps_name_files_that_exist():
    files = set(jax_files())
    assert set(RENAMED_MODULES) <= files
    assert set(NOT_PORTED_MODULES) <= files
    assert not set(RENAMED_MODULES) & set(NOT_PORTED_MODULES)
    for path, port in RENAMED_MODULES.items():
        assert os.path.isfile(os.path.join(REPO, port))
        assert not os.path.exists(os.path.join(REPO, counterpart(path)))


# utils/roofs.py: JAX name -> the port's, or None and the reason
ROOF_NAMES = {
    "HBM_ROOF": "PEAK_BYTES_PER_S",
    "vpu_roof": "fp32_roof",
    "mxu_roof": "matmul_roof",
    "calibrate_mxu_roof": "calibrate_matmul_roof",
    "dot_flops": "matmul_flops",
    # XLA's compiled cost model, which eager PyTorch does not have; it
    # counts a scanned body once (R17), and matmul_flops counts every
    # product a call runs
    "split_cost": None,
    "combine_loop_cost": None,
}


def jax_roof_names() -> list:
    with open(os.path.join(REPO, JAX_PKG, "utils", "roofs.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("name", jax_roof_names())
def test_every_public_roof_name_has_a_counterpart_or_a_reason(name):
    assert name in ROOF_NAMES, f"roofs.{name} is neither mapped nor refused"
    if ROOF_NAMES[name] is not None:
        assert hasattr(roofs, ROOF_NAMES[name])
    else:
        assert not hasattr(roofs, name)
