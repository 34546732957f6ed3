"""Planar and radial flows (Rezende and Mohamed, 2015).

Port of ``flowstate_tpu/flows/elementary.py``:

* ``Planar`` (:22): ``f(z) = z + u h(w.z + b)``, with ``u`` moved so that
  ``w.u > -1`` (:40-43), ``h`` tanh or leaky_relu, and an algebraic
  inverse for leaky_relu only;
* ``Radial`` (:84): ``f(z) = z + beta h(alpha, r) (z - z0)``, no inverse.

Softplus is ``log(1 + e^x)`` written as ``logaddexp(x, 0)``, JAX's form
(``F.softplus`` returns ``x`` itself above 20).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _uniform(shape, low, high, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return low + (high - low) * u


@dataclasses.dataclass(frozen=True)
class Planar:
    dim: int
    act: str = "tanh"
    negative_slope: float = 0.2

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        lim_w = math.sqrt(2.0 / self.dim)
        lim_u = math.sqrt(2.0)
        kw = dict(generator=generator, dtype=dtype, device=device)
        return {"u": _uniform((self.dim,), -lim_u, lim_u, **kw),
                "w": _uniform((self.dim,), -lim_w, lim_w, **kw),
                "b": torch.zeros((), dtype=dtype, device=device)}

    def _constrained_u(self, params):
        """``u`` moved along ``w`` so that ``w.u > -1``."""
        u, w = params["u"], params["w"]
        inner = torch.sum(w * u)
        return u + (_softplus(inner) - 1.0 - inner) * w / torch.sum(w ** 2)

    def _h(self, x):
        if self.act == "tanh":
            return torch.tanh(x)
        if self.act == "leaky_relu":
            return torch.where(x < 0, self.negative_slope * x, x)
        raise NotImplementedError("Nonlinearity is not implemented.")

    def _h_prime(self, x):
        if self.act == "tanh":
            return 1.0 / torch.cosh(x) ** 2
        return self._slopes(x)

    def _slopes(self, x):
        """leaky_relu's slope at ``x``, in ``x``'s dtype."""
        return torch.where(x < 0, torch.full_like(x, self.negative_slope),
                           torch.ones_like(x))

    def forward(self, params, z):
        w, b = params["w"], params["b"]
        u = self._constrained_u(params)
        lin = torch.sum(w * z, dim=-1, keepdim=True) + b
        z_ = z + u * self._h(lin)
        log_det = torch.log(torch.abs(
            1.0 + torch.sum(w * u) * self._h_prime(lin[..., 0])))
        return z_, log_det

    def inverse(self, params, z):
        if self.act != "leaky_relu":
            raise NotImplementedError("This flow has no algebraic inverse.")
        w, b = params["w"], params["b"]
        u = self._constrained_u(params)
        lin = torch.sum(w * z, dim=-1) + b
        a = self._slopes(lin)
        u_eff = a[:, None] * u
        inner = torch.sum(w * u_eff, dim=-1)
        z_ = z - u_eff * (lin / (1.0 + inner))[:, None]
        return z_, -torch.log(torch.abs(1.0 + inner))


@dataclasses.dataclass(frozen=True)
class Radial:
    dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        lim = 1.0 / self.dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        return {"beta": _uniform((), -lim - 1.0, lim - 1.0, **kw),
                "alpha": _uniform((), -lim, lim, **kw),
                "z_0": torch.randn((self.dim,), **kw)}

    def forward(self, params, z):
        alpha = torch.abs(params["alpha"])
        beta = _softplus(params["beta"]) - alpha
        dz = z - params["z_0"]
        r = torch.linalg.norm(dz, dim=-1, keepdim=True)
        h = beta / (alpha + r)
        h_prime = -beta * r / (alpha + r) ** 2
        z_ = z + h * dz
        log_det = ((self.dim - 1) * torch.log(1.0 + h[..., 0])
                   + torch.log(1.0 + h[..., 0] + h_prime[..., 0]))
        return z_, log_det

    def inverse(self, params, z):
        raise NotImplementedError("Radial flow has no algebraic inverse.")
