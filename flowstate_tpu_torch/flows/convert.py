"""Carry flow weights between the JAX package's layout and the port's.

The JAX flow's parameters are a tuple with one pytree per layer of the
``NormalizingFlow``; ``build_circular_flow`` has one ``ScannedLayers``,
whose leaves are stacked ``(K, ...)``:

    ({"net": {"initial": {"w": (K, in, out), "b": (K, out)},
              "blocks": [{"l1": {...}, "l2": {...}}, ...],
              "final": {...}},
      "uncond": {"widths", "heights", "derivatives"}},)

The conditional flow (``build_conditional_circular_flow``) has the same
tuple, with a ``"ctx": {"w": (K, ctx, hidden), "b": (K, hidden)}`` linear
in every block beside ``l1`` and ``l2``.  The other conditioners' ``net``
trees are the transformer's ``{"embed", "blocks": [{"qkv", "proj", "ff1",
"ff2"}, ...], "final"}`` and the gnn's ``{"embed", "layers": [{"msg",
"upd"}, ...], "final"}``.  An unstacked flow (``scan_layers=False``) has a
tuple of K such trees without the K axis, one per ``ParamLayer``.  The
port keeps the same trees (``flows/core.py::ParamTree``), so the
carry-over is a copy leaf by leaf with the structure and the shapes
checked.  Leaves are numpy arrays on the JAX side.

The flow zoo's layers (``flows.core.ParamLayer`` over an ``affine``,
``mixing``, ``autoregressive``, ... configuration) keep their JAX trees
too, so a ``NormalizingFlow`` or ``ClassCondFlow`` of them is a tuple of
those trees (``{}`` for a layer without parameters, ``None`` for a
missing net).  A module with one tree of its own, ``ParamLayer`` (a
single layer, or a trainable base's ``{"loc", "log_scale"}``) or
``NormalizingFlowVAE`` (``{"encoder", "flows", "decoder"}``), carries
that tree alone.  A ``MultiscaleFlow`` is JAX's ``{"flows": (one tuple
of layer trees a level), "transform": the transform's tree or None}``.
Trees may hold 0-d leaves (``InducedNormMLP``'s ``beta``, learnable
orders) and list-rooted nets (a ``Residual``'s ``{"net": [...]}``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from flowstate_tpu_torch.flows.core import tree_map


def _has_layers(module: nn.Module) -> bool:
    return hasattr(module, "layers")


def _is_multiscale(module: nn.Module) -> bool:
    return hasattr(module, "merges")


def _layer_trees(flow: nn.Module):
    return [layer.params.tree() for layer in flow.layers]


def _multiscale_tree(flow: nn.Module):
    return {"flows": tuple(tuple(layer.params.tree() for layer in level)
                           for level in flow.flows),
            "transform": (None if flow.transform is None
                          else flow.transform.params.tree())}


def params_from_jax(tree: Sequence, flow: nn.Module) -> nn.Module:
    """Copy the JAX parameter tuple ``tree`` (numpy leaves) into ``flow``
    (a ``NormalizingFlow``, ``ConditionalNormalizingFlow`` or
    ``ClassCondFlow``), or the one tree of a ``ParamLayer``,
    ``NormalizingFlowVAE`` or ``MultiscaleFlow``, in the module's dtype
    and on its device; returns ``flow``."""
    if _is_multiscale(flow):
        tree, ours = (tree,), (_multiscale_tree(flow),)
    elif _has_layers(flow):
        if isinstance(tree, dict):
            tree = (tree,)
        ours = _layer_trees(flow)
        if len(tree) != len(ours):
            raise ValueError(f"{len(tree)} layer trees for a flow of "
                             f"{len(ours)} layers")
    else:
        tree, ours = (tree,), (flow.params.tree(),)

    def copy(dst: torch.Tensor, src) -> None:
        if src is None:
            raise ValueError("a None leaf for a tensor of the flow")
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"leaf of shape {src.shape}, the flow's is "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.as_tensor(src, dtype=dst.dtype))

    for dst, src in zip(ours, tree):
        _check_structure(dst, src)
        tree_map(copy, dst, src)
    return flow


def _check_structure(dst, src, path: str = "") -> None:
    """The same dict keys and list lengths at every level (a conditional
    tree's ``ctx`` leaves against an unconditional flow, and back)."""
    if dst is None:
        if src is not None:
            raise ValueError(f"tree at {path or '/'} has leaves where the "
                             f"flow has none")
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError(f"tree at {path or '/'} does not have the "
                             f"flow's keys {sorted(dst)}")
        for k in dst:
            _check_structure(dst[k], src[k], f"{path}/{k}")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError(f"tree at {path or '/'} is not a list of "
                             f"{len(dst)}")
        for i, (d, s_) in enumerate(zip(dst, src)):
            _check_structure(d, s_, f"{path}/{i}")


def params_to_jax(flow: nn.Module):
    """The flow's parameters in the JAX layout, as numpy arrays: a tuple
    of layer trees, or a ``ParamLayer``'s, ``NormalizingFlowVAE``'s or
    ``MultiscaleFlow``'s one tree."""
    def to_numpy(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    if _is_multiscale(flow):
        return to_numpy(_multiscale_tree(flow))
    if not _has_layers(flow):
        return to_numpy(flow.params.tree())
    return tuple(to_numpy(tree) for tree in _layer_trees(flow))
