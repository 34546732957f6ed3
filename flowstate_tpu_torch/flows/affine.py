"""Affine flow layers (the RealNVP and Glow family).

Port of ``flowstate_tpu/flows/affine.py``:

* ``AffineConstFlow`` (:27): a learned scale and shift per dimension;
* ``CCAffineConst`` (:53): its class-conditional form, given a one-hot
  ``y`` (B, classes);
* ``_affine_apply`` (:81): the three scale maps ``exp``, ``sigmoid`` and
  ``sigmoid_inv``;
* ``AffineCoupling`` (:101): RealNVP's coupling on a split ``[z1, z2]``,
  the net's output interleaved (even columns the shift, odd the scale);
* ``MaskedAffineFlow`` (:148): ``b z + (1 - b)(z e^s(bz) + t(bz))``;
  without ``s_net`` the scale is 0 (NICE), and a net's non-finite output
  becomes NaN, as JAX maps it;
* ``AffineCouplingBlock`` (:200): split the features in halves, couple,
  join.

The nets are ``flows.nets`` configurations (``MLP``, ``ResidualNet``);
their trees sit under ``"net"``, ``"s"`` and ``"t"`` as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


def _zeros(dim, dtype, device):
    return torch.zeros((dim,), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class AffineConstFlow:
    """``z e^s + t`` with ``s`` and ``t`` per dimension (each switched off
    by ``scale`` / ``shift``)."""

    dim: int
    scale: bool = True
    shift: bool = True

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"s": _zeros(self.dim, dtype, device),
                "t": _zeros(self.dim, dtype, device)}

    def _st(self, params):
        s, t = params["s"], params["t"]
        return (s if self.scale else torch.zeros_like(s),
                t if self.shift else torch.zeros_like(t))

    def forward(self, params, z):
        s, t = self._st(params)
        return z * torch.exp(s) + t, torch.sum(s).expand(z.shape[0])

    def inverse(self, params, z):
        s, t = self._st(params)
        return (z - t) * torch.exp(-s), (-torch.sum(s)).expand(z.shape[0])


@dataclasses.dataclass(frozen=True)
class CCAffineConst:
    """The class-conditional affine const flow: ``s = s0 + y S``,
    ``t = t0 + y T``; ``forward`` / ``inverse`` take ``y`` too."""

    dim: int
    num_classes: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        kw = dict(dtype=dtype, device=device)
        return {"s": torch.zeros((self.dim,), **kw),
                "t": torch.zeros((self.dim,), **kw),
                "s_cc": torch.zeros((self.num_classes, self.dim), **kw),
                "t_cc": torch.zeros((self.num_classes, self.dim), **kw)}

    def _st(self, params, y):
        return (params["s"] + y @ params["s_cc"],
                params["t"] + y @ params["t_cc"])

    def forward(self, params, z, y):
        s, t = self._st(params, y)
        return z * torch.exp(s) + t, torch.sum(s, dim=-1)

    def inverse(self, params, z, y):
        s, t = self._st(params, y)
        return (z - t) * torch.exp(-s), -torch.sum(s, dim=-1)


def _affine_apply(z2, shift, scale_raw, scale_map: str, inverse: bool):
    """``(z2', log-det per element)`` under one of the three scale maps."""
    if scale_map == "exp":
        if inverse:
            return (z2 - shift) * torch.exp(-scale_raw), -scale_raw
        return z2 * torch.exp(scale_raw) + shift, scale_raw
    if scale_map == "sigmoid":
        scale = torch.sigmoid(scale_raw + 2.0)
        if inverse:
            return (z2 - shift) * scale, torch.log(scale)
        return z2 / scale + shift, -torch.log(scale)
    if scale_map == "sigmoid_inv":
        scale = torch.sigmoid(scale_raw + 2.0)
        if inverse:
            return (z2 - shift) / scale, -torch.log(scale)
        return z2 * scale + shift, torch.log(scale)
    raise NotImplementedError(f"scale map {scale_map} not implemented")


@dataclasses.dataclass(frozen=True)
class AffineCoupling:
    """RealNVP coupling on ``[z1, z2]``: ``param_map`` (a net) maps z1 to
    the interleaved shift and scale of z2 (only a shift without
    ``scale``)."""

    param_map: Any
    scale: bool = True
    scale_map: str = "exp"

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self.param_map.init_params(generator, dtype=dtype,
                                                  device=device)}

    def _params_for(self, params, z1):
        raw = self.param_map.apply(params["net"], z1)
        if self.scale:
            return raw[:, 0::2], raw[:, 1::2]
        return raw, None

    def _apply(self, params, z, inverse: bool):
        z1, z2 = z
        shift, scale_raw = self._params_for(params, z1)
        if self.scale:
            z2, ld = _affine_apply(z2, shift, scale_raw, self.scale_map,
                                   inverse)
            return [z1, z2], torch.sum(ld, dim=-1)
        z2 = z2 - shift if inverse else z2 + shift
        return [z1, z2], torch.zeros_like(z2[:, 0])

    def forward(self, params, z: Tuple[torch.Tensor, torch.Tensor]):
        return self._apply(params, z, inverse=False)

    def inverse(self, params, z: Tuple[torch.Tensor, torch.Tensor]):
        return self._apply(params, z, inverse=True)


@dataclasses.dataclass(frozen=True)
class MaskedAffineFlow:
    """Masked RealNVP with the 0/1 mask ``b``: ``s_net`` and ``t_net``
    see ``b z``; a missing net gives zeros."""

    b: Tuple[int, ...]
    s_net: Optional[Any] = None
    t_net: Optional[Any] = None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        kw = dict(dtype=dtype, device=device)
        return {
            "s": (self.s_net.init_params(generator, **kw)
                  if self.s_net else None),
            "t": (self.t_net.init_params(generator, **kw)
                  if self.t_net else None),
        }

    def _maps(self, params, z_masked):
        nan = torch.full_like(z_masked, float("nan"))

        def net(cfg, p):
            if cfg is None:
                return torch.zeros_like(z_masked)
            out = cfg.apply(p, z_masked)
            return torch.where(torch.isfinite(out), out, nan)

        return net(self.s_net, params["s"]), net(self.t_net, params["t"])

    def forward(self, params, z):
        b = torch.as_tensor(self.b, dtype=z.dtype, device=z.device)
        z_masked = b * z
        scale, trans = self._maps(params, z_masked)
        z_ = z_masked + (1 - b) * (z * torch.exp(scale) + trans)
        return z_, torch.sum((1 - b) * scale, dim=-1)

    def inverse(self, params, z):
        b = torch.as_tensor(self.b, dtype=z.dtype, device=z.device)
        z_masked = b * z
        scale, trans = self._maps(params, z_masked)
        z_ = z_masked + (1 - b) * (z - trans) * torch.exp(-scale)
        return z_, -torch.sum((1 - b) * scale, dim=-1)


@dataclasses.dataclass(frozen=True)
class AffineCouplingBlock:
    """Split the features in halves, ``AffineCoupling``, join."""

    param_map: Any
    scale: bool = True
    scale_map: str = "exp"

    def _coupling(self) -> AffineCoupling:
        return AffineCoupling(self.param_map, self.scale, self.scale_map)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return self._coupling().init_params(generator, dtype=dtype,
                                            device=device)

    def _apply(self, params, z, inverse: bool):
        d = z.shape[-1]
        halves = (z[:, :d // 2], z[:, d // 2:])
        step = self._coupling().inverse if inverse else \
            self._coupling().forward
        (z1, z2), log_det = step(params, halves)
        return torch.cat([z1, z2], dim=-1), log_det

    def forward(self, params, z):
        return self._apply(params, z, inverse=False)

    def inverse(self, params, z):
        return self._apply(params, z, inverse=True)
