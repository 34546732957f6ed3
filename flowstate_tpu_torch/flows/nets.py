"""The coupling layers' parameter network, as functions of a parameter tree.

Port of the part of ``flowstate_tpu/flows/nets.py`` the circular flow uses:
``ResidualNet`` (nets.py:71) with ``use_norm=True``, ``_layer_norm``
(:61), ``_linear_init`` (:36) and ``PeriodicFeaturesElementwise`` (:345).

Parameters are a tree of tensors shaped like the JAX pytree: a linear
layer is ``{"w": (in, out), "b": (out,)}`` (the transpose of
``nn.Linear.weight``), and the net is ``{"initial", "blocks": [{"l1",
"l2"}, ...], "final"}``.  ``apply`` also takes a tree whose leaves carry a
leading batch of nets, ``w`` (G, in, out) and ``b`` (G, out), with inputs
(G, B, in): the paired flow step runs two layers' nets in one batched
product that way.

With ``context_features`` the net is conditional, as the JAX net's
(nets.py:145-146, 167-169): the context joins the featurised input of the
``initial`` layer, and each block's residual is gated by
``sigmoid(ctx(context))``, a linear ``blk["ctx"]`` of shape (ctx, hidden)
(a GLU).  The context itself is not featurised.  The ``transformer`` and
``gnn`` nets are ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Tree = Dict[str, object]


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             dtype, device) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, dtype=dtype, device=device)
            * (2.0 * bound) - bound)


def _linear_init(in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator],
                 dtype=torch.float32, device="cuda") -> Tree:
    """``nn.Linear``'s default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform((in_dim, out_dim), bound, generator, dtype, device),
            "b": _uniform((out_dim,), bound, generator, dtype, device)}


def _linear(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; with a leading net axis, (G, B, in) @ (G, in, out)."""
    return torch.matmul(x, params["w"]) + params["b"].unsqueeze(-2)


def _layer_norm(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Biased variance, ``eps`` inside the rsqrt, no affine."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


@dataclasses.dataclass(frozen=True)
class PeriodicFeaturesElementwise:
    """The whole input to ``[cos(s x), sin(s x)]``, doubling the width."""

    ndim: int
    scale: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.cos(self.scale * x),
                          torch.sin(self.scale * x)], dim=-1)


@dataclasses.dataclass(frozen=True)
class ResidualNet:
    """Pre-activation residual MLP with LayerNorm before each activation
    (the JAX net with ``use_norm=True``, as the couplings build it), with
    the context GLU when ``context_features`` is set."""

    in_features: int
    out_features: int
    hidden_features: int
    num_blocks: int = 2
    preprocessing: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    context_features: Optional[int] = None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    identity_bias: float = 0.0, dtype=torch.float32,
                    device="cuda") -> Tree:
        """The JAX init's distributions with ``init_identity``, drawn from
        ``generator``: the second linear of each block U(-1e-3, 1e-3), the
        final layer w = 0 and b = ``identity_bias``; a block's ``ctx``
        linear as ``nn.Linear``'s default."""
        h = self.hidden_features
        ctx = self.context_features
        kw = dict(dtype=dtype, device=device)
        params = {"initial": _linear_init(self.in_features + (ctx or 0), h,
                                          generator, **kw)}
        blocks = []
        for _ in range(self.num_blocks):
            l1 = _linear_init(h, h, generator, **kw)
            l2 = {"w": _uniform((h, h), 1e-3, generator, **kw),
                  "b": _uniform((h,), 1e-3, generator, **kw)}
            block = {"l1": l1, "l2": l2}
            if ctx:
                block["ctx"] = _linear_init(ctx, h, generator, **kw)
            blocks.append(block)
        params["blocks"] = blocks
        params["final"] = {
            "w": torch.zeros((h, self.out_features), **kw),
            "b": torch.full((self.out_features,), identity_bias, **kw)}
        return params

    def apply(self, params: Tree, x: torch.Tensor,
              context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The net on ``x``; a conditional net also takes ``context``,
        (B, ctx), or (G, B, ctx) beside a batch of G nets."""
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        if self.context_features:
            x = torch.cat([x, context], dim=-1)
        t = _linear(params["initial"], x)
        for blk in params["blocks"]:
            r = _linear(blk["l1"], torch.relu(_layer_norm(t)))
            r = _linear(blk["l2"], torch.relu(_layer_norm(r)))
            if self.context_features:
                r = r * torch.sigmoid(_linear(blk["ctx"], context))
            t = t + r
        return _linear(params["final"], t)
