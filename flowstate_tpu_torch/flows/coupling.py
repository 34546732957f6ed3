"""Rational-quadratic spline coupling layers (circular and linear tails).

Port of ``flowstate_tpu/flows/coupling.py::CircularSplineCoupling`` (:76)
and ``CoupledRationalQuadraticSpline`` (:354), with the masks
``create_alternating_binary_mask`` (:45), ``create_mid_split_binary_mask``
(:53) and ``create_random_binary_mask`` (:61), and ``sum_except_batch``
(:70).  The layer is an ``nn.Module`` with no parameters of its own: it
holds the static configuration, and its methods take a parameter tree
``{"net": ..., "uncond": {"widths", "heights", "derivatives"}}`` shaped
like the JAX pytree (``flows/core.py::ScannedLayers`` keeps K layers' trees
stacked on a leading axis and hands one layer's slice to each step).

What the JAX layer does and this one copies:

* the flow's forward (latent -> data) is the coupling's inverse and the
  other way round (coupling.py:289-295);
* both coupling directions roll the features by ``features // 2``;
* the net's raw widths and heights are scaled by ``1/sqrt(hidden)``
  before the softmax, and it emits ``3 * bins + 1`` values per transformed
  dimension;
* the unconditional spline on the identity half starts at identity;
* the coupling's inverse runs the conditioner on the identity half after
  its unconditional inverse;
* with ``context_features`` (coupling.py:108-109, 214-218) the context
  goes to the conditioner's net only, never to the identity half's
  unconditional spline; the paired step gives both nets of the pair the
  same context;
* the conditioner is chosen by ``net_type`` (coupling.py:155-191): a
  residual net on the periodic features (LayerNorm unless ``use_norm`` is
  False, ``compute_dtype`` its option), a transformer on them (``num_heads``
  heads, ``num_blocks`` layers, embedding ``hidden_units``), or a torus
  EGNN over the identity half's coordinates scaled by pi / tail_bound; a
  context is refused for the transformer and the gnn with JAX's
  ``ValueError``, here when the layer is built.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from flowstate_tpu_torch.flows.nets import (
    ConstScaleLayer, PeriodicFeaturesElementwise, ResidualNet, TorusEGNN,
    TransformerNet, Tree,
)
from flowstate_tpu_torch.ops.splines import (
    IDENTITY_DERIVATIVE_CONSTANT, unconstrained_rational_quadratic_spline_sum,
)
from flowstate_tpu_torch.utils.profiling import annotate


def create_alternating_binary_mask(features: int, even: bool = True
                                   ) -> np.ndarray:
    """Alternating 0/1 mask, ones from index 0 (``even``) or 1."""
    mask = np.zeros(features, dtype=np.int8)
    mask[0 if even else 1::2] = 1
    return mask


def create_mid_split_binary_mask(features: int) -> np.ndarray:
    """Ones on the first half (the larger half for an odd count)."""
    mask = np.zeros(features, dtype=np.int8)
    mask[:features - features // 2] = 1
    return mask


def create_random_binary_mask(features: int, seed: int = 0) -> np.ndarray:
    """Ones on a random half (the larger for an odd count), drawn by
    numpy's ``default_rng(seed)`` as the JAX mask is: the same bits."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(features, dtype=np.int8)
    mask[rng.choice(features, size=features - features // 2,
                    replace=False)] = 1
    return mask


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def _roll(x: torch.Tensor, split: int) -> torch.Tensor:
    return torch.cat([x[:, split:], x[:, :split]], dim=1)


class CircularSplineCoupling(nn.Module):
    """One circular RQ-spline coupling layer (configuration only).

    features: flow dimension (2N); num_blocks, hidden_units: the
    conditioner's depth and width; ind_circ: the circular coordinates;
    num_bins; tail_bound: half box (the torus is [-b, b]^D); net_type:
    ``"residual"``, ``"transformer"`` or ``"gnn"``; reverse_mask flips the
    alternating mask, and ``mask`` (0/1 per feature) replaces it;
    context_features makes the residual conditioner conditional (the
    context GLU); num_heads: the transformer's; use_norm: the residual
    net's LayerNorm; init_identity: the net's output layer starts at the
    identity spline (the unconditional spline always does); compute_dtype:
    the residual net's.  Each circular dimension's end slopes are tied (the
    JAX default ``circular_tie=True``).
    """

    def __init__(self, features: int, num_blocks: int, hidden_units: int,
                 ind_circ: Sequence[int], num_bins: int = 8,
                 tail_bound: float = 3.0, net_type: str = "residual",
                 reverse_mask: bool = False,
                 context_features: Optional[int] = None,
                 num_heads: int = 4, mask: Optional[Sequence[int]] = None,
                 use_norm: bool = True, init_identity: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if net_type not in ("residual", "transformer", "gnn"):
            raise ValueError(f"net_type must be 'residual', 'transformer' or "
                             f"'gnn', got {net_type!r}")
        if context_features and net_type != "residual":
            raise ValueError("context is only wired through the residual "
                             "backend (as in the reference: resnet.py:48-49)")
        self.features = features
        self.num_blocks = num_blocks
        self.hidden_units = hidden_units
        self.num_bins = num_bins
        self.tail_bound = float(tail_bound)
        self.net_type = net_type
        self.num_heads = num_heads
        self.use_norm = use_norm
        self.init_identity = init_identity
        self.context_features = context_features
        self.compute_dtype = compute_dtype
        m = (np.asarray(mask, dtype=np.int8) if mask is not None
             else create_alternating_binary_mask(features, even=reverse_mask))
        self.identity_idx = np.where(m <= 0)[0]
        self.transform_idx = np.where(m > 0)[0]
        circ = set(ind_circ)
        self.tails_identity = ["circular" if i in circ else "linear"
                               for i in self.identity_idx]
        self.tails_transform = ["circular" if i in circ else "linear"
                                for i in self.transform_idx]
        self.param_multiplier = 3 * num_bins + 1
        # index tensors move with the module (``.to(device)``), so no
        # host-to-device copy per call; the last puts (identity | transform)
        # back in feature order
        for name, idx in (("_id", self.identity_idx),
                          ("_tr", self.transform_idx),
                          ("_unsplit", np.argsort(np.concatenate(
                              [self.identity_idx, self.transform_idx])))):
            self.register_buffer(name, torch.as_tensor(idx, dtype=torch.long),
                                 persistent=False)
        self.net = self._make_net()

    def _make_net(self):
        """The conditioner of ``net_type`` (JAX's ``_net``)."""
        d_id = len(self.identity_idx)
        out_features = len(self.transform_idx) * self.param_multiplier
        scale = math.pi / self.tail_bound
        if self.net_type == "transformer":
            return TransformerNet(
                in_features=2 * d_id, out_features=out_features,
                embed_dim=self.hidden_units, num_heads=self.num_heads,
                num_layers=self.num_blocks,
                preprocessing=PeriodicFeaturesElementwise(d_id, scale))
        if self.net_type == "gnn":
            return TorusEGNN(
                num_node=d_id, out_dim=out_features, feat_dim=1,
                hidden_dim=self.hidden_units, num_layers=self.num_blocks,
                preprocessing=ConstScaleLayer(scale))
        return ResidualNet(
            in_features=2 * d_id, out_features=out_features,
            hidden_features=self.hidden_units, num_blocks=self.num_blocks,
            preprocessing=PeriodicFeaturesElementwise(d_id, scale),
            context_features=self.context_features, use_norm=self.use_norm,
            compute_dtype=self.compute_dtype)

    # ----- params -------------------------------------------------------

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda") -> Tree:
        d_id = len(self.identity_idx)
        net = self.net.init_params(
            generator, identity_bias=IDENTITY_DERIVATIVE_CONSTANT,
            dtype=dtype, device=device, init_identity=self.init_identity)
        kw = dict(dtype=dtype, device=device)
        uncond = {
            "widths": torch.zeros((d_id, self.num_bins), **kw),
            "heights": torch.zeros((d_id, self.num_bins), **kw),
            "derivatives": torch.full((d_id, self.num_bins + 1),
                                      IDENTITY_DERIVATIVE_CONSTANT, **kw),
        }
        return {"net": net, "uncond": uncond}

    # ----- pieces -------------------------------------------------------

    def _split(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return x.index_select(1, self._id), x.index_select(1, self._tr)

    def _scatter(self, identity: torch.Tensor, transform: torch.Tensor
                 ) -> torch.Tensor:
        return torch.cat([identity, transform], dim=1).index_select(
            1, self._unsplit)

    def _cond_spline_from_raw(self, raw: torch.Tensor,
                              transform_split: torch.Tensor, inverse: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        raw = raw.reshape(raw.shape[0], len(self.transform_idx),
                          self.param_multiplier)
        nb = self.num_bins
        return unconstrained_rational_quadratic_spline_sum(
            transform_split, raw[..., :nb], raw[..., nb:2 * nb],
            raw[..., 2 * nb:], inverse=inverse, tails=self.tails_transform,
            tail_bound=self.tail_bound,
            scale=1.0 / math.sqrt(self.hidden_units))

    def _apply_net(self, net_params: Tree, x: torch.Tensor,
                   context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conditioner's raw spline parameters (a span ``flow.net``)."""
        with annotate("flow.net"):
            if self.context_features:
                return self.net.apply(net_params, x, context)
            return self.net.apply(net_params, x)

    def _conditional_spline(self, p: Tree, identity_split: torch.Tensor,
                            transform_split: torch.Tensor, inverse: bool,
                            context: Optional[torch.Tensor] = None):
        raw = self._apply_net(p["net"], identity_split, context)
        return self._cond_spline_from_raw(raw, transform_split, inverse)

    def _unconditional_spline(self, p: Tree, identity_split: torch.Tensor,
                              inverse: bool):
        u = p["uncond"]
        b = identity_split.shape[0]
        return unconstrained_rational_quadratic_spline_sum(
            identity_split, u["widths"].expand(b, *u["widths"].shape),
            u["heights"].expand(b, *u["heights"].shape),
            u["derivatives"].expand(b, *u["derivatives"].shape),
            inverse=inverse, tails=self.tails_identity,
            tail_bound=self.tail_bound)

    def _coupling_forward(self, p: Tree, x: torch.Tensor, context=None):
        identity_split, transform_split = self._split(x)
        transform_out, logdet = self._conditional_spline(
            p, identity_split, transform_split, inverse=False,
            context=context)
        identity_out, logdet_id = self._unconditional_spline(
            p, identity_split, inverse=False)
        out = self._scatter(identity_out, transform_out)
        return _roll(out, self.features // 2), logdet + logdet_id

    def _coupling_inverse(self, p: Tree, x: torch.Tensor, context=None):
        x = _roll(x, self.features // 2)
        identity_split, transform_split = self._split(x)
        identity_out, logdet = self._unconditional_spline(
            p, identity_split, inverse=True)
        transform_out, logdet_tr = self._conditional_spline(
            p, identity_out, transform_split, inverse=True, context=context)
        return (self._scatter(identity_out, transform_out),
                logdet + logdet_tr)

    # ----- flow directions ----------------------------------------------

    def forward(self, p: Tree, z: torch.Tensor, context=None):
        """Latent -> data (sampling direction): ``(x, log_det)``."""
        return self._coupling_inverse(p, z, context)

    def inverse(self, p: Tree, x: torch.Tensor, context=None):
        """Data -> latent (log_prob direction): ``(z, log_det)``."""
        return self._coupling_forward(p, x, context)

    def paired_forward_inverse(self, p2: Tree, z_f: torch.Tensor,
                               x_i: torch.Tensor, context=None):
        """A flow-forward step on ``z_f`` with the layer of ``p2``'s slice
        0 and a flow-inverse step on ``x_i`` with slice 1, the two nets run
        as one batched product (``p2``'s leaves carry a leading axis of 2;
        a (B, ctx) ``context`` is broadcast to (2, B, ctx)).  Returns
        ``((y_f, log_det_f), (y_i, log_det_i))`` as the separate
        ``forward`` and ``inverse`` would."""
        split = self.features // 2
        p_f = {"uncond": {k: v[0] for k, v in p2["uncond"].items()}}
        p_i = {"uncond": {k: v[1] for k, v in p2["uncond"].items()}}
        idf, trf = self._split(_roll(z_f, split))
        idf_out, ld_id_f = self._unconditional_spline(p_f, idf, inverse=True)
        idi, tri = self._split(x_i)
        idi_out, ld_id_i = self._unconditional_spline(p_i, idi, inverse=False)
        ctx2 = (None if context is None
                else context.expand(2, *context.shape))
        raw2 = self._apply_net(p2["net"], torch.stack([idf_out, idi]), ctx2)
        trf_out, ld_tr_f = self._cond_spline_from_raw(raw2[0], trf,
                                                      inverse=True)
        tri_out, ld_tr_i = self._cond_spline_from_raw(raw2[1], tri,
                                                      inverse=False)
        yf = self._scatter(idf_out, trf_out)
        yi = _roll(self._scatter(idi_out, tri_out), split)
        return (yf, ld_id_f + ld_tr_f), (yi, ld_tr_i + ld_id_i)


class CoupledRationalQuadraticSpline(CircularSplineCoupling):
    """The linear-tail NSF coupling: the same layer with linear tails on
    every dimension (``ind_circ`` empty by default) and a residual net
    without LayerNorm on the raw identity half (no periodic features)."""

    def __init__(self, features: int, num_blocks: int, hidden_units: int,
                 ind_circ: Sequence[int] = (), **kwargs):
        super().__init__(features, num_blocks, hidden_units, ind_circ,
                         **kwargs)

    def _make_net(self):
        return ResidualNet(
            in_features=len(self.identity_idx),
            out_features=len(self.transform_idx) * self.param_multiplier,
            hidden_features=self.hidden_units, num_blocks=self.num_blocks,
            use_norm=False)
