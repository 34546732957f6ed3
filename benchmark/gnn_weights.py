"""The torus EGNN flow's weights, made on the device from the seed in one
draw, by the rules of ``weights.py`` (whose helpers it uses).

The tree has the layout the program documents for its gnn flow
(``flows/nets.py::TorusEGNN``, every leaf stacked on a leading K axis),
worked out from the configuration's widths, with H the hidden width, L
the layers and out the transformed half's 3 bins + 1 values a feature:
``net.embed`` (K, 2, H), ``net.layers[l].msg`` (K, 2H + 2, H),
``net.layers[l].upd`` (K, 2H, H), ``net.final`` (K, H, out), and the
layers' own splines ``uncond``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.weights import (
    IDENTITY_DERIVATIVE, ROLES, _linear, _lists, _role_columns, tree_map,
)

__all__ = ["leaves", "make", "count", "tree_map"]


def leaves(flow: dict, dim: int) -> List[Tuple[tuple, tuple, str]]:
    """``(path, shape, role)`` of every leaf of the gnn flow of ``flow``
    (the configuration's ``flow`` block) on ``dim`` features."""
    if flow["net_type"] != "gnn":
        raise ValueError(f"net_type {flow['net_type']!r} is not the gnn")
    k, h, bins = flow["K"], flow["hidden_units"], flow["num_bins"]
    d_id, d_tr = dim - dim // 2, dim // 2
    shapes: list = []
    _linear(shapes, ("net", "embed"), k, 2, h)
    for i in range(flow["n_blocks"]):
        _linear(shapes, ("net", "layers", i, "msg"), k, 2 * h + 2, h)
        _linear(shapes, ("net", "layers", i, "upd"), k, 2 * h, h)
    _linear(shapes, ("net", "final"), k, h, d_tr * (3 * bins + 1), "final")
    for role in ROLES:
        shapes.append((("uncond", role),
                       (k, d_id, bins + (role == "derivatives")), "uncond"))
    return shapes


def make(flow: dict, init: dict, dim: int, seed: int, device
         ) -> Dict[str, object]:
    """The flow's tree, float32 on ``device``, from one normal draw of a
    generator seeded with ``seed`` (``weights.make``'s rules)."""
    layout = leaves(flow, dim)
    sizes = [math.prod(shape) for _, shape, _ in layout]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    bins = flow["num_bins"]
    tree: dict = {}
    offset = 0
    for (path, shape, role), size in zip(layout, sizes):
        z = flat[offset:offset + size].reshape(shape)
        offset += size
        leaf = path[-1]
        if role == "uncond":
            std = init["uncond_std"][leaf]
            x = z * std + (IDENTITY_DERIVATIVE if leaf == "derivatives" else 0.0)
        elif role == "final":
            cols = _role_columns(shape[-1], bins, device)
            if leaf == "w":
                std = torch.tensor([init["final_w_std"][r] for r in ROLES],
                                   device=device)[cols] / math.sqrt(shape[1])
                x = z * std
            else:
                std = torch.tensor([init["final_b_std"][r] for r in ROLES],
                                   device=device)[cols]
                x = z * std + (cols == 2).float() * IDENTITY_DERIVATIVE
        elif leaf == "w":
            x = z * (init["linear_std"] / math.sqrt(shape[1]))
        else:
            x = z * init["bias_std"]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = x.contiguous()
    return _lists(tree)


def count(flow: dict, dim: int) -> int:
    """The flow's parameters."""
    return sum(math.prod(shape) for _, shape, _ in leaves(flow, dim))
