"""The move kernel's launch arithmetic and its wrapper, on the CPU.

The CUDA kernel (``flowstate_tpu_torch/csrc/metropolis_moves.cu``) runs
only on the card (``chip_smoke.py`` holds it there against the plain
version, and the Python mirror of its thread table against the built
kernel's own).  What surrounds it is plain Python and is held here: the
threads-per-chain rule and the launch it implies, the rule's thresholds
against the constants in the CUDA source, the division-free particle
index against ``bits % n``, the wrapper's refusals, and the CPU dispatch
against the plain version.  The plain version itself is held against the
JAX engine and the Pallas kernel in ``tests/test_torch_metropolis.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132  # streaming multiprocessors of an H100


def _source():
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc",
                           "metropolis_moves.cu")) as f:
        return f.read()


def _state(n=3, c=8, seed=1):
    spec = tops.SystemSpec.create(n, tops.Box.from_density(n, 0.03, 1.0),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)
    pos, _ = tmcmc.init_alternating_wells(c, n, 0.03)
    return spec, tmcmc.init_chain_state(spec, torch.as_tensor(pos), seed, 0.65)


# the particle counts the launch tests sweep: every N to 8192, then the
# opt-in edge and the device-memory path
SWEPT_NS = list(range(1, 8193)) + [28_928, 28_929, 32_768, 40_000, 2 ** 20]


@pytest.mark.parametrize("c", [1, 100, 130, 512, 16384])
def test_launch_shape_for_every_particle_count(c):
    for n in SWEPT_NS:
        s = cm.launch_shape(n, c)
        assert s.group == cm.group_threads(n)
        assert s.group >= 4 and s.group & (s.group - 1) == 0, (n, s)
        assert s.block == max(32, s.group) <= 1024
        assert s.chains_per_block * s.group == s.block
        assert s.stride >= n and s.stride % s.group == 0
        assert (s.stride // s.group) % 2 == 1
        planes = 2 * s.chains_per_block * s.stride
        assert s.path == cm.memory_path(n)
        total = 4 * planes + cm.static_shared_bytes(s.group)
        if s.path == cm.PATH_DEVICE:
            assert s.shared_bytes == 0 and s.scratch_floats == s.grid * planes
            assert total > cm.H100_SHARED_OPTIN_BYTES
        else:
            assert s.shared_bytes == 4 * planes and s.scratch_floats == 0
            limit = (cm.MAX_SHARED_BYTES if s.path == cm.PATH_SHARED
                     else cm.H100_SHARED_OPTIN_BYTES)
            assert total <= limit, (n, s)
            if s.path == cm.PATH_SHARED_OPT_IN:
                assert total > cm.MAX_SHARED_BYTES
        # every chain has its group, and no block is without a chain
        assert s.grid * s.chains_per_block >= c
        assert (s.grid - 1) * s.chains_per_block < c
        if c == 512 and n >= 128:
            assert s.grid >= SMS, (n, s)


@pytest.mark.parametrize("n,path,stride", [
    (2048, cm.PATH_SHARED, 2304),
    (8192, cm.PATH_SHARED_OPT_IN, 8448),
    (40_000, cm.PATH_DEVICE, 40_192),
])
def test_group_rule_and_memory_path_above_the_old_cap(n, path, stride):
    """K1 takes every N: 256 threads a chain above N = 512, the planes in
    shared memory up to 48 KB (N = 5,888), opted-in shared memory up to the
    H100's 227 KB a block (N = 28,928), device memory above."""
    assert cm.group_threads(n) == 256
    assert cm.memory_path(n) == path
    s = cm.launch_shape(n, 128)
    assert (s.block, s.chains_per_block, s.grid, s.stride) == (256, 1, 128,
                                                               stride)
    assert cm.PATH_NAMES[path] in ("shared", "shared_opt_in", "device")
    # the edges of the three paths
    assert cm.memory_path(5888) == cm.PATH_SHARED
    assert cm.memory_path(5889) == cm.PATH_SHARED_OPT_IN
    assert cm.memory_path(28_928) == cm.PATH_SHARED_OPT_IN
    assert cm.memory_path(28_929) == cm.PATH_DEVICE
    # a card that allows less opts in to less
    assert cm.memory_path(8192, optin_bytes=64 * 1024) == cm.PATH_DEVICE


@pytest.mark.parametrize("n", [1, 3, 4, 5, 12, 16])
def test_chains_of_a_warp_lie_on_different_banks(n):
    """Groups smaller than a warp: the lanes of one warp, each reading its
    own chain's particle ``lane + k * group``, touch 32 different banks."""
    s = cm.launch_shape(n, 1000)
    assert s.group < 32
    for turn in range(-(-n // s.group)):
        banks = {(slot * s.stride + turn * s.group + lane) % 32
                 for slot in range(s.chains_per_block)
                 for lane in range(s.group)}
        assert len(banks) == 32


def test_group_rule_is_the_cuda_sources():
    src = _source()

    def const(name):
        m = re.search(rf"static constexpr int {name} = ([^;]+);", src)
        assert m, name
        return eval(m.group(1), {"__builtins__": {}})

    assert const("kGroup4MaxN") == cm.GROUP4_MAX_N
    assert const("kGroup8MaxN") == cm.GROUP8_MAX_N
    assert const("kWarpMaxN") == cm.WARP_MAX_N
    assert const("kBlock128MaxN") == cm.BLOCK128_MAX_N
    assert const("kMaxSharedBytes") == cm.MAX_SHARED_BYTES
    assert [const(f"kPath{name}") for name in
            ("Shared", "SharedOptIn", "Device")] == [
        cm.PATH_SHARED, cm.PATH_SHARED_OPT_IN, cm.PATH_DEVICE]
    # no particle cap: the entry point refuses only n < 1
    assert "kMaxParticles" not in src
    assert "return n < 1 ? 0 : group_threads(n);" in src
    # the path rule: planes plus a float2 and an int per warp, against
    # 48 KB, then the card's opt-in maximum, read from the card
    assert "2LL * kChains * plane_stride<G>(n) * sizeof(float) +" in src
    assert "((G < 32 ? 32 : G) / 32) * (int)(sizeof(float2) + sizeof(int))" \
        in src
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    # the table's body, in order, and one kernel instance per group size
    body = src[src.index("static int group_threads(int n)"):]
    body = body[:body.index("}")]
    assert re.findall(r"n <= (\w+)\) return (\d+);", body) == [
        ("kGroup4MaxN", "4"), ("kGroup8MaxN", "8"), ("kWarpMaxN", "32"),
        ("kBlock128MaxN", "128")]
    assert re.search(r"return 256;\s*$", body)
    groups = {cm.group_threads(n) for n in SWEPT_NS}
    assert groups == {4, 8, 32, 128, 256}
    assert {int(g) for g in re.findall(r"FS_LAUNCH\((\d+)\);", src)} == groups
    # the stride and the reciprocal, as the mirror computes them
    assert "(long long)G * ((((long long)n + G - 1) / G) | 1)" in src
    assert "~0ull / (unsigned int)P.n + 1ull" in src


@pytest.mark.parametrize("n", [0, -1])
def test_group_rule_refuses_counts_outside_the_kernels_range(n):
    with pytest.raises(ValueError, match="particles"):
        cm.group_threads(n)


def test_particle_index_equals_the_remainder():
    rng = np.random.default_rng(0)
    edges = [0, 1, 2, 3, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31,
             2 ** 31 + 1, 2 ** 32 - 2, 2 ** 32 - 1]
    bits = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint64),
                           np.array(edges, dtype=np.uint64)])
    # every N to 1024, then the new range: the paths' edges, powers of two,
    # odd counts and the int32 planes' limit
    wide = [2048, 4096, 5888, 5889, 8192, 28_928, 28_929, 32_768, 40_000,
            65_537, 2 ** 20 - 1, 2 ** 20, 12_345_679, 2 ** 30 - 1]
    for n in list(range(1, 1025)) + wide:
        # multiples of n and their neighbours, where a quotient error shows
        near = (np.arange(2 ** 32 // n - 3, 2 ** 32 // n + 1, dtype=np.uint64)
                * np.uint64(n))
        b = np.concatenate([bits, near - np.uint64(1), near])
        b = b[b < 2 ** 32]
        idx = cm.particle_index(b, n)
        np.testing.assert_array_equal(idx, (b % np.uint64(n)).astype(np.int64),
                                      err_msg=f"n={n}")
        assert idx.min() >= 0 and idx.max() < n


def test_kernel_refuses_cpu_tensors_and_builds_nothing():
    spec, s = _state()
    before = cm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cm.run_moves_kernel(spec, 1.0, s, 10)
    with pytest.raises(ValueError, match="CUDA"):
        cm.kernel_division(torch.ones(4), torch.ones(4))
    assert cm.LAUNCHES == before
    from flowstate_tpu_torch.kernels import build
    assert build._LOADED is None


@pytest.mark.parametrize("bad,match", [
    (lambda t: t.double(), "float32"),
    (lambda t: t[:, :2], "shape"),
    (lambda t: t.transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
    (lambda t: t.to("meta"), "is on meta"),
])
def test_tensor_checks_name_what_is_wrong(bad, match):
    _, s = _state()
    c, n = s.positions.shape[:2]
    cm._check("positions", s.positions, (c, n, 2), torch.float32,
              s.positions.device)
    with pytest.raises(ValueError, match=match):
        cm._check("positions", bad(s.positions), (c, n, 2), torch.float32,
                  s.positions.device)


def test_auto_dispatch_on_cpu_is_the_plain_version_and_keeps_its_input():
    spec, s = _state(n=3, c=16, seed=4)
    before = {f: getattr(s, f).clone() for f in TENSOR_FIELDS}
    auto = cm.run_moves_auto(spec, 1.0, s, 60)
    plain = cm.run_moves_plain(spec, 1.0, s, 60)
    for f in ("positions", "energy", "accepts", "attempts", "max_disp"):
        assert torch.equal(getattr(auto, f), getattr(plain, f)), f
    assert torch.isnan(auto.virial).all() and auto.calls == s.calls + 1
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(s, f), before[f]), f
    with pytest.raises(ValueError, match="no move engine"):
        cm.run_moves_auto(spec, 1.0, s.replace(
            positions=s.positions.to("meta")), 5)
