"""The flow's weights, made on the device from the seed in one draw.

The tree has the layout the program documents for its flows
(``flows/convert.py``: the JAX package's pytree, every leaf stacked on a
leading K axis), worked out here from the configuration's widths.  Each
leaf is ``mean + std * N(0, 1)`` by its role, with the stds of the
configuration's ``init`` (its ``assumed`` weights, not trained ones):

* a hidden linear: w with std ``linear_std / sqrt(in)``, b with std
  ``bias_std``;
* the final linear, whose outputs are each transformed feature's bin
  widths, bin heights and knot derivatives: w with std
  ``final_w_std[role] / sqrt(in)`` and b with std ``final_b_std[role]``,
  the derivatives' bias centred on the identity slope;
* the layers' own splines: ``uncond_std[role]``, derivatives centred on
  the identity slope.

So the bins are uneven and move with the conditioner's input, and a
flow of random weights still maps the torus onto itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# softplus^-1(1 - 1e-3): the knot parameter whose slope is exactly 1
IDENTITY_DERIVATIVE = math.log(math.expm1(1.0 - 1e-3))

ROLES = ("widths", "heights", "derivatives")


def _linear(shapes, path, k, fan_in, fan_out, role="hidden"):
    shapes.append((path + ("w",), (k, fan_in, fan_out), role))
    shapes.append((path + ("b",), (k, fan_out), role))


def leaves(flow: dict, dim: int) -> List[Tuple[tuple, tuple, str]]:
    """``(path, shape, role)`` of every leaf of the flow of ``flow`` (the
    configuration's ``flow`` block) on ``dim`` features."""
    k, h, bins = flow["K"], flow["hidden_units"], flow["num_bins"]
    d_id, d_tr = dim - dim // 2, dim // 2
    out = d_tr * (3 * bins + 1)
    seq = 2 * d_id
    shapes: list = []
    net = ("net",)
    if flow["net_type"] == "residual":
        _linear(shapes, net + ("initial",), k, seq, h)
        for i in range(flow["n_blocks"]):
            _linear(shapes, net + ("blocks", i, "l1"), k, h, h)
            _linear(shapes, net + ("blocks", i, "l2"), k, h, h)
        _linear(shapes, net + ("final",), k, h, out, "final")
    elif flow["net_type"] == "transformer":
        _linear(shapes, net + ("embed",), k, 1, h)
        for i in range(flow["n_blocks"]):
            blk = net + ("blocks", i)
            _linear(shapes, blk + ("qkv",), k, h, 3 * h)
            _linear(shapes, blk + ("proj",), k, h, h)
            _linear(shapes, blk + ("ff1",), k, h, 4 * h)
            _linear(shapes, blk + ("ff2",), k, 4 * h, h)
        _linear(shapes, net + ("final",), k, seq * h, out, "final")
    else:
        raise ValueError(f"no weights for net_type {flow['net_type']!r}")
    for role in ROLES:
        shapes.append((("uncond", role),
                       (k, d_id, bins + (role == "derivatives")), "uncond"))
    return shapes


def _role_columns(n: int, bins: int, device) -> torch.Tensor:
    """The role (0 widths, 1 heights, 2 derivatives) of each of the final
    linear's ``n`` outputs."""
    j = torch.arange(n, device=device) % (3 * bins + 1)
    return (j >= bins).long() + (j >= 2 * bins).long()


def make(flow: dict, init: dict, dim: int, seed: int, device
         ) -> Dict[str, object]:
    """The flow's tree, float32 on ``device``, from one normal draw of a
    generator seeded with ``seed``."""
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


def _lists(node):
    """Dicts keyed 0..n-1 (the blocks) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def count(flow: dict, dim: int) -> int:
    """The flow's parameters."""
    return sum(math.prod(shape) for _, shape, _ in leaves(flow, dim))


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)
