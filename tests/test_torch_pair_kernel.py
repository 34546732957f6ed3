"""The port's pair-energy module (``flowstate_tpu_torch.ops.cuda_pair``)
against the JAX package.

The plain version, reached through ``mcmc.state.batched_energy_virial`` on
a CPU batch, is held per chain against the JAX ``total_energy_virial``
(vmapped) and against the Pallas kernel ``total_energy_virial_pallas`` in
interpret mode, on the same numpy inputs: jittered lattices at N = 3, 100
and 300 with the two wells, C = 4.  Tolerance: |Δ| <= 1e-5 * |ref| + 1e-4
for energies and virials, tighter than tests/test_pallas_pair.py's rtol
2e-4, atol 1e-2: the packages sum the pairs in other orders and round
``sqrt`` and the division independently (the largest difference seen is
6.1e-5 on a virial of order 1e2).  The CUDA kernel runs
only on the card and is held against this plain version there
(``chip_smoke.py``).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.ops.pallas_pair import total_energy_virial_pallas
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.state import batched_energy_virial
from flowstate_tpu_torch.ops import cuda_pair

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-4
WELLS = dict(num_wells=2, V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def _system(n, c, seed, rho=0.3):
    """JAX and port specs and a (C, N, 2) float32 batch: the lattice of
    ``initialise_fcc`` jittered by +-0.05 per chain, wrapped."""
    lattice, box = jmcmc.initialise_fcc(n, rho, 1.0)
    rng = np.random.default_rng(seed)
    pos = lattice + rng.uniform(-0.05, 0.05, size=(c, n, 2))
    pos = np.stack([pos[..., 0] % box.size_x, pos[..., 1] % box.size_y], -1)
    jspec = jops.SystemSpec.create(n, jops.Box(box.size_x, box.size_y),
                                   **WELLS)
    tspec = tops.SystemSpec.create(n, tops.Box(box.size_x, box.size_y),
                                   **WELLS)
    return jspec, tspec, pos.astype(np.float32)


@pytest.mark.parametrize("n", [3, 100, 300])
def test_plain_matches_jax_total_energy_virial(n):
    jspec, tspec, pos = _system(n, 4, seed=n)
    e_ref, w_ref = jax.vmap(lambda p: jops.total_energy_virial(jspec, p))(
        jnp.asarray(pos))
    e, w = batched_energy_virial(tspec, torch.as_tensor(pos))
    assert e.dtype == w.dtype == torch.float32 and e.shape == (4,)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n", [3, 100, 300])
def test_plain_matches_pallas_interpret(n):
    jspec, tspec, pos = _system(n, 4, seed=10 + n)
    e, w = batched_energy_virial(tspec, torch.as_tensor(pos))
    for c in range(4):
        e_ref, w_ref = total_energy_virial_pallas(jspec, jnp.asarray(pos[c]),
                                                  interpret=True)
        np.testing.assert_allclose(float(e[c]), float(e_ref), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(w[c]), float(w_ref), rtol=RTOL,
                                   atol=ATOL)


def test_hard_core_gives_inf_in_exactly_the_overlapping_chains():
    jspec, tspec, pos = _system(100, 5, seed=3)
    for c in (1, 3):
        pos[c, 57] = pos[c, 12] + np.float32(0.1)
    e, w = batched_energy_virial(tspec, torch.as_tensor(pos))
    overlapping = np.array([False, True, False, True, False])
    np.testing.assert_array_equal(np.isinf(e.numpy()), overlapping)
    np.testing.assert_array_equal(np.isinf(w.numpy()), overlapping)
    assert np.all(e.numpy()[overlapping] > 0)
    assert np.all(np.isfinite(e.numpy()[~overlapping]))
    e_ref, _ = total_energy_virial_pallas(jspec, jnp.asarray(pos[1]),
                                          interpret=True)
    assert np.isinf(float(e_ref))


def test_chunked_plain_path_equals_unchunked():
    _, tspec, pos = _system(100, 7, seed=4)
    pos = torch.as_tensor(pos)
    e_full, w_full = batched_energy_virial(tspec, pos)
    for chunk_elems in (2 * 100 * 100, 3 * 2 * 100 * 100):   # 1, 3 chains
        e, w = batched_energy_virial(tspec, pos, chunk_elems=chunk_elems)
        torch.testing.assert_close(e, e_full, rtol=0, atol=0)
        torch.testing.assert_close(w, w_full, rtol=0, atol=0)


def test_batched_energy_virial_refuses_other_devices():
    _, tspec, _ = _system(3, 2, seed=0)
    with pytest.raises(ValueError, match="device meta"):
        batched_energy_virial(tspec, torch.empty((2, 3, 2), device="meta"))


def test_kernel_wrapper_checks_its_input_and_refuses_cpu_tensors():
    _, tspec, pos = _system(100, 3, seed=5)
    good = torch.as_tensor(pos)
    before = cuda_pair.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pair.total_energy_virial_kernel(tspec, good)
    with pytest.raises(ValueError, match="float32"):
        cuda_pair.total_energy_virial_kernel(tspec, good.double())
    with pytest.raises(ValueError, match="shape|\\(C, 100, 2\\)"):
        cuda_pair.total_energy_virial_kernel(tspec, good[:, :99])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pair.total_energy_virial_kernel(
            tspec, good.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="one chain"):
        cuda_pair.total_energy_virial_kernel(tspec, good[:0])
    assert cuda_pair.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 16, 17, 255, 256, 257, 1024,
                               4096])
def test_the_pair_split_covers_every_unordered_pair_once(n):
    """The mirrored circulant split, at the threads per chain the kernel
    launches for one chain and for 128 on a 132-SM card (and 256 and 2048
    threads above a warp's range): every pair i < j exactly once, each
    thread's pairs in one row per unit, and no thread more than one unit
    above the mean."""
    threads = {cuda_pair.launch_shape(n, c, 132).threads for c in (1, 128)}
    if n > cuda_pair.WARP_MAX_N:
        threads |= {256, 2048}
    for p in sorted(threads):
        g, i, j = cuda_pair.thread_pairs(n, p)
        assert np.all((0 <= g) & (g < p) & (i != j))
        lo, hi = np.minimum(i, j).astype(np.int64), np.maximum(i, j)
        seen = np.bincount(lo * n + hi, minlength=n * n).reshape(n, n)
        np.testing.assert_array_equal(seen, np.triu(np.ones((n, n),
                                                            np.int64), 1))
        _, kseg, units = cuda_pair.split(n, p)
        per_thread = np.bincount(g, minlength=p)
        assert per_thread.max() <= units * kseg
        assert per_thread.max() - len(g) / p <= kseg
        # a thread's pairs run j = i + 1, i + 2, ... (mod n) along a row
        first = g == 0
        if first.sum() > 1:
            step = (j[first][1:] - i[first][1:]) - (j[first][:-1]
                                                   - i[first][:-1])
            rows = i[first][1:] == i[first][:-1]
            assert np.all(step[rows] % n == 1)


def test_launch_table_at_its_edges():
    shape = cuda_pair.launch_shape
    # lane groups: 4 lanes to N=4, 8 to N=16, a warp to N=32, 32 / G chains
    # per one-warp block; the main path is 13 warps
    assert [shape(n, 1, 132).threads for n in (1, 4, 5, 16, 17, 32)] == [
        4, 4, 8, 8, 32, 32]
    assert shape(3, 100, 132) == (4, 0, 13, 32, 1, 1, 1, 0)
    assert shape(1, 1, 132) == (4, 0, 1, 32, 1, 0, 1, 0)     # no pair
    assert shape(2, 9, 132) == (4, 0, 2, 32, 1, 1, 1, 0)
    assert shape(16, 130, 132).blocks == 33        # a part-filled warp
    assert shape(32, 33, 132) == (32, 0, 33, 32, 1, 16, 1, 0)
    # clusters from N=33: blocks = C x cluster, the chain staged up to 52 KB
    for n, c in ((33, 1), (128, 512), (257, 64), (1024, 128), (1024, 512),
                 (4096, 4), (4437, 3), (4438, 3), (10_000, 1)):
        sh = shape(n, c, 132)
        assert 1 <= sh.cluster <= cuda_pair.MAX_CLUSTER
        assert (sh.block, sh.threads, sh.blocks) == (256, 256 * sh.cluster,
                                                     c * sh.cluster)
        assert (sh.segments, sh.seg_len, sh.units) == cuda_pair.split(
            n, sh.threads)
        staged = (n + n // 2 + sh.segments) * 8
        assert sh.shared_bytes == (staged if staged <= 52 * 1024 else 0)
    assert shape(4437, 3, 132).shared_bytes == 53248
    assert shape(4438, 3, 132).shared_bytes == 0
    # the single run's shape: 4 blocks per chain, one row per thread, one
    # wave of 512 blocks; with 512 chains one block each
    assert shape(1024, 128, 132) == (1024, 4, 512, 256, 1, 512, 1, 12296)
    assert shape(1024, 512, 132) == (256, 1, 512, 256, 1, 512, 4, 12296)
    # many chains fill the card without clusters where a block's threads
    # use every row; fewer SMs, smaller clusters
    assert shape(1024, 100_000, 132).cluster == 1
    assert shape(300, 64, 132).cluster == 8
    assert shape(300, 64, 16).cluster < 8


def test_kernel_launch_is_bound_once_and_counts_one_per_call(monkeypatch):
    """The wrapper's launch with the library stubbed: the entry point's
    argtypes set at the first call only, one launch counted per call, a
    cudaError raised and not counted; the parameters made once per
    (spec, C, SMs)."""
    calls, bound = [], []

    class Entry:
        restype = None
        rc = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                bound.append(value)
            object.__setattr__(self, name, value)

        def __call__(self, params, pos, out, stream):
            calls.append((pos, out, stream))
            return self.rc

    entry = Entry()

    class Library:
        flowstate_pair_energy = entry

    monkeypatch.setattr(cuda_pair, "_library", lambda: Library)
    monkeypatch.setattr(cuda_pair, "_ENTRY", None)
    _, tspec, pos = _system(100, 3, seed=6)
    pos = torch.as_tensor(pos)
    out = torch.empty((2, 3))
    params = cuda_pair._params(tspec, 3, 132)
    assert params is cuda_pair._params(tspec, 3, 132)
    assert (params.num_chains, params.n, params.num_sms) == (3, 100, 132)
    before = cuda_pair.LAUNCHES
    for _ in range(3):
        cuda_pair._launch(params, pos, out, 7)
    assert cuda_pair.LAUNCHES == before + 3
    assert len(bound) == 1 and len(calls) == 3
    assert calls[0] == (pos.data_ptr(), out.data_ptr(), 7)
    entry.rc = 719
    with pytest.raises(RuntimeError, match="cudaError 719"):
        cuda_pair._launch(params, pos, out, 7)
    assert cuda_pair.LAUNCHES == before + 3 and len(bound) == 1


def _c_struct_fields(source: str, struct: str):
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc", source)) as f:
        body = re.search(r"struct %s \{(.*?)\};" % struct, f.read(),
                         re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.match(r"(unsigned int|int|float)\s+(.*);",
                                line).groups()
        fields += [(name.strip(), ctype) for name in names.split(",")]
    return fields


@pytest.mark.parametrize("source,struct,mirror", [
    ("pair_energy.cu", "PairParams", cuda_pair._PairParams),
    ("metropolis_moves.cu", "MoveParams", cm._MoveParams),
])
def test_params_structs_mirror_the_cuda_sources_field_by_field(
        source, struct, mirror):
    ctypes_names = {"c_int": "int", "c_uint": "unsigned int",
                    "c_float": "float"}
    mine = [(name, ctypes_names[t.__name__]) for name, t in mirror._fields_]
    assert mine == _c_struct_fields(source, struct)


def test_cuda_pair_imports_without_nvcc_and_builds_nothing():
    code = ("import sys, flowstate_tpu_torch.ops.cuda_pair as m; "
            "b = sys.modules.get('flowstate_tpu_torch.kernels.build'); "
            "ok = m.LAUNCHES == 0 and (b is None or b._LOADED is None); "
            "sys.exit(0 if ok else 1)")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": os.path.join(REPO, "no-such-cuda")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
