"""The yardstick's counts: the published peaks of one NVIDIA H100, the
matrix products of a flow pass worked out from the configuration's
widths, and the move and pair-energy kernels' operations and bytes.

Peaks: NVIDIA's H100 SXM data sheet, float32 outside the tensor cores
(67 TFLOP/s) and HBM3 (3.35 TB/s), at the card's full 700 W.

A product of (M, K) by (K, N) is 2 M K N operations; biases, layer
norms, softmax, activations and the splines' elementwise arithmetic are
not products and are not counted.  The move kernel's operations per move
and its bytes are those of ``flowstate_tpu_torch/tools/n_scaling.py``
(``k1_ops_per_move``, ``k1_bound``), read off ``csrc/metropolis_moves.cu``
(an FMA counts two) and frozen here; the pair-energy kernel (K2) is
counted by its distances and well terms alone, a lower bound, since its
LJ arithmetic runs only for the pairs inside the cutoff.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# K1: a pair term, a well term, the proposal with its wrap and decision
K1_PAIR_FLOPS, K1_WELL_FLOPS, K1_MOVE_FLOPS = 22, 22, 18
# K2: a pair's distance, a particle's well term
K2_DISTANCE_FLOPS, K2_WELL_FLOPS = 13, 22


def conditioner_flops(flow: dict, dim: int) -> int:
    """Product operations of one conditioner call on one configuration."""
    h, bins = flow["hidden_units"], flow["num_bins"]
    d_id, d_tr = dim - dim // 2, dim // 2
    seq, out = 2 * d_id, d_tr * (3 * bins + 1)
    if flow["net_type"] == "residual":
        return 2 * (seq * h + 2 * flow["n_blocks"] * h * h + h * out)
    if flow["net_type"] == "transformer":
        block = (2 * seq * h * 3 * h          # qkv
                 + 2 * 2 * seq * seq * h      # scores and their sum over v
                 + 2 * seq * h * h            # proj
                 + 2 * 2 * seq * h * 4 * h)   # ff1, ff2
        return 2 * seq * h + flow["n_blocks"] * block + 2 * seq * h * out
    raise ValueError(f"no count for net_type {flow['net_type']!r}")


def flow_pass_flops(flow: dict, dim: int, chains: int) -> int:
    """Product operations of one pass (``log_prob`` or
    ``sample_and_log_prob``) of ``chains`` configurations: one conditioner
    call per coupling."""
    return flow["K"] * chains * conditioner_flops(flow, dim)


def k1_ops_per_move(n: int, num_wells: int) -> int:
    return (2 * (n - 1) * K1_PAIR_FLOPS + 2 * num_wells * K1_WELL_FLOPS
            + K1_MOVE_FLOPS)


def k1_ops(chains: int, n: int, num_wells: int, moves: int) -> int:
    return chains * moves * k1_ops_per_move(n, num_wells)


def k1_bytes(chains: int, n: int) -> int:
    """A launch reads and writes each chain's positions, energy, maximum
    displacement, accept and attempt counts once."""
    return chains * (2 * n * 2 * 4 + 4 * 4)


def k2_ops(chains: int, n: int, num_wells: int) -> int:
    return chains * (n * (n - 1) // 2 * K2_DISTANCE_FLOPS
                     + n * num_wells * K2_WELL_FLOPS)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: operations at the float32
    peak against bytes at the HBM rate."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
