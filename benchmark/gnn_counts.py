"""The torus EGNN conditioner's least products, and its message passing's
operations and bytes, for the yardstick of ``counts.py``.

Least: each product counted once where the algebra allows.  The message
product splits by its input's parts, ``W_m [h_i, h_j, e_ij] = W_a h_i +
W_b h_j + W_e e_ij``, so ``W_a h`` and ``W_b h`` are one product per node
and ``W_e e`` one per ordered pair of distinct nodes.  Per row, with n
nodes, H the hidden width, L layers and out the final linear's width:

* embedding: ``2 n 2 H``;
* each layer: ``2 (2 n H H)`` (``W_a h``, ``W_b h``), ``2 n (n - 1) 2 H``
  (``W_e e``) and ``2 n 2H H`` (the update);
* final: ``2 H out``.

Any implementation of the same mathematics needs at least these, so a
share of a peak computed from them cannot pass 100%.  The program's own
products (``flows/nets.py::TorusEGNN``, the message product over all
n x n pairs) are some four times as many at N=8.

The message passing's least bytes a row and layer: the n node states in
and out and the n coordinates, ``(2 n H + n) 4``.
"""

from __future__ import annotations


def _widths(flow: dict, dim: int) -> tuple:
    if flow["net_type"] != "gnn":
        raise ValueError(f"net_type {flow['net_type']!r} is not the gnn")
    n = dim - dim // 2
    return n, flow["hidden_units"], dim // 2 * (3 * flow["num_bins"] + 1)


def layer_flops(n: int, h: int) -> int:
    """Least product operations of one message-passing layer on one row."""
    return 2 * (2 * n * h * h) + 2 * n * (n - 1) * 2 * h + 2 * n * 2 * h * h


def layer_bytes(n: int, h: int) -> int:
    """Least float32 bytes of one message-passing layer on one row."""
    return (2 * n * h + n) * 4


def conditioner_flops(flow: dict, dim: int) -> int:
    """Least product operations of one conditioner call on one row."""
    n, h, out = _widths(flow, dim)
    return (2 * n * 2 * h + flow["n_blocks"] * layer_flops(n, h)
            + 2 * h * out)


def flow_pass_flops(flow: dict, dim: int, chains: int) -> int:
    """Least product operations of one flow pass of ``chains`` rows: one
    conditioner call per coupling."""
    return flow["K"] * chains * conditioner_flops(flow, dim)


def messages(flow: dict, dim: int, chains: int) -> int:
    """Messages of one flow pass of ``chains`` rows: n (n - 1) a row, layer
    and coupling."""
    n, _, _ = _widths(flow, dim)
    return flow["K"] * chains * n * (n - 1) * flow["n_blocks"]
