"""The benchmark's own counts held to the program's tools: the products
of a flow pass against ``utils/roofs.py::matmul_flops`` (PyTorch's
``FlopCounterMode``) on small flows of both conditioners, the move
kernel's operations and bytes against ``tools/n_scaling.py``, the peaks
against ``utils/roofs.py``."""

import math

import pytest
import torch

from benchmark import counts
from benchmark.tests.standin import tiny_config


@pytest.mark.parametrize("net,n", [("residual", 3), ("transformer", 4),
                                   ("residual", 8)])
def test_flow_pass_products_match_the_flop_counter(net, n):
    from flowstate_tpu_torch.flows import build_circular_flow
    from flowstate_tpu_torch.utils.roofs import matmul_flops

    f = tiny_config("t", n, net)["flow"]
    f.update(K=3, hidden_units=32, n_blocks=2, num_bins=5)
    half_box = math.sqrt(n / 0.03) / 2
    model = build_circular_flow(
        n, 2, half_box, K=f["K"], hidden_units=f["hidden_units"],
        num_bins=f["num_bins"], num_blocks=f["n_blocks"], net_type=net,
        device="cpu")
    chains = 7
    want = counts.flow_pass_flops(f, 2 * n, chains)
    x = torch.rand(chains, 2 * n) * half_box
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert matmul_flops(model.log_prob, x) == want
        assert matmul_flops(model.sample_and_log_prob, chains, g) == want


@pytest.mark.parametrize("n", [1, 3, 8, 1024])
def test_k1_counts_match_the_n_scaling_tool(n):
    from flowstate_tpu_torch.tools import n_scaling

    assert counts.k1_ops_per_move(n, 2) == n_scaling.k1_ops_per_move(n, 2)
    ms, _ = n_scaling.k1_bound(16384, n, 2, 1000)
    ours = counts.bound_s(counts.k1_ops(16384, n, 2, 1000),
                          counts.k1_bytes(16384, n))
    assert ours * 1e3 == pytest.approx(ms, rel=1e-12)


def test_k2_lower_count_is_the_tools_count_without_lj_terms():
    from flowstate_tpu_torch.tools import n_scaling

    assert (counts.K2_DISTANCE_FLOPS, counts.K2_WELL_FLOPS) == \
        (n_scaling.K2_DISTANCE_FLOPS, n_scaling.K2_WELL_FLOPS)
    assert counts.k2_ops(4096, 8, 2) == (4096 * 28 * n_scaling.K2_DISTANCE_FLOPS
                                         + 4096 * 8 * 2
                                         * n_scaling.K2_WELL_FLOPS)


def test_peaks_are_the_programs_published_ones():
    from flowstate_tpu_torch.utils import roofs

    assert counts.PEAK_FP32_FLOPS == roofs.PEAK_FP32_FLOPS
    assert counts.PEAK_BYTES_PER_S == roofs.PEAK_BYTES_PER_S
