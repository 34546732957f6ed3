"""Mixing flow layers: permutations and invertible linear maps.

Port of ``flowstate_tpu/flows/mixing.py``:

* ``Permute`` (:26): a fixed shuffle of the channels, or a swap of their
  halves.  The shuffle is numpy's ``default_rng(seed).permutation``, as in
  JAX, so both packages permute alike;
* ``_lu_assemble`` (:62) and ``InvertibleAffine`` (:71): a D x D linear
  map, ``W = P L U`` with a unit lower ``L``, a parameterised diagonal of
  ``U`` and a fixed permutation ``P`` (log-det the sum of the log
  diagonal, two triangular solves for the inverse), or a dense ``W``
  initialised by the QR of a normal matrix (log-det by ``slogdet``);
* ``LULinearPermute`` (:140): a permutation seeded with ``seed + 1``
  before the LU linear;
* ``Invertible1x1Conv`` (:169): ``InvertibleAffine`` over the channels of
  an NCHW image.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from flowstate_tpu_torch.flows.base import ParameterFree


def _permutation(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def _inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


@dataclasses.dataclass(frozen=True)
class Permute(ParameterFree):
    """Channel permutation: ``"shuffle"`` or ``"swap"``."""

    num_channels: int
    mode: str = "shuffle"
    seed: int = 0

    def _perm(self) -> np.ndarray:
        return _permutation(self.num_channels, self.seed)

    def _apply(self, z, inverse: bool):
        log_det = torch.zeros_like(z[:, 0])
        if self.mode == "shuffle":
            perm = self._perm()
            return z[:, _inverse_permutation(perm) if inverse else perm], \
                log_det
        if self.mode == "swap":
            h = ((self.num_channels + 1) if inverse
                 else self.num_channels) // 2
            return torch.cat([z[:, h:], z[:, :h]], dim=1), log_det
        raise NotImplementedError(f"mode {self.mode} is not implemented.")

    def forward(self, params, z):
        return self._apply(z, inverse=False)

    def inverse(self, params, z):
        return self._apply(z, inverse=True)


def _lu_assemble(params, dim):
    """``(L, U)``: unit-diagonal lower, upper with diagonal
    ``exp(log_upper_diag) * sign_upper_diag``."""
    lower = params["lower"]
    eye = torch.eye(dim, dtype=lower.dtype, device=lower.device)
    lower = torch.tril(lower, diagonal=-1) + eye
    upper = torch.triu(params["upper"], diagonal=1) + torch.diag(
        torch.exp(params["log_upper_diag"]) * params["sign_upper_diag"])
    return lower, upper


@dataclasses.dataclass(frozen=True)
class InvertibleAffine:
    """A D x D invertible linear layer, LU-parameterised by default."""

    dim: int
    use_lu: bool = True
    seed: int = 0

    def _permutation(self) -> np.ndarray:
        return _permutation(self.dim, self.seed)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        kw = dict(generator=generator, dtype=dtype, device=device)
        if not self.use_lu:
            # a random orthogonal matrix: the QR of a normal one
            q, _ = torch.linalg.qr(torch.randn((self.dim, self.dim), **kw))
            return {"weight": q}
        # near the identity, with small noise (nflows' _LULinear init)
        eps = 1e-3 / math.sqrt(self.dim)
        return {
            "lower": eps * torch.randn((self.dim, self.dim), **kw),
            "upper": eps * torch.randn((self.dim, self.dim), **kw),
            "log_upper_diag": torch.zeros((self.dim,), dtype=dtype,
                                          device=device),
            "sign_upper_diag": torch.ones((self.dim,), dtype=dtype,
                                          device=device),
        }

    def _weight_logdet(self, params):
        if not self.use_lu:
            w = params["weight"]
            return w, torch.linalg.slogdet(w)[1]
        lower, upper = _lu_assemble(params, self.dim)
        return lower @ upper, torch.sum(params["log_upper_diag"])

    def forward(self, params, z):
        w, logdet = self._weight_logdet(params)
        z_ = z @ w.T
        if self.use_lu:
            # the fixed permutation P of W = P L U (|det P| = 1)
            z_ = z_[:, self._permutation()]
        return z_, logdet.expand(z.shape[0])

    def inverse(self, params, z):
        if self.use_lu:
            z = z[:, _inverse_permutation(self._permutation())]
            lower, upper = _lu_assemble(params, self.dim)
            # (L U) x = z^T by two triangular solves
            y = torch.linalg.solve_triangular(lower, z.T, upper=False)
            z_ = torch.linalg.solve_triangular(upper, y, upper=True).T
            logdet = -torch.sum(params["log_upper_diag"])
        else:
            w = params["weight"]
            z_ = torch.linalg.solve(w, z.T).T
            logdet = -torch.linalg.slogdet(w)[1]
        return z_, logdet.expand(z.shape[0])


@dataclasses.dataclass(frozen=True)
class LULinearPermute:
    """A fixed permutation, then the LU linear ``InvertibleAffine``."""

    dim: int
    seed: int = 0

    def _inner(self) -> InvertibleAffine:
        return InvertibleAffine(self.dim, use_lu=True, seed=self.seed)

    def _perm(self) -> np.ndarray:
        return _permutation(self.dim, self.seed + 1)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return self._inner().init_params(generator, dtype=dtype,
                                         device=device)

    def forward(self, params, z):
        return self._inner().forward(params, z[:, self._perm()])

    def inverse(self, params, z):
        z, log_det = self._inner().inverse(params, z)
        return z[:, _inverse_permutation(self._perm())], log_det


@dataclasses.dataclass(frozen=True)
class Invertible1x1Conv:
    """Glow's invertible 1 x 1 convolution on NCHW images."""

    num_channels: int
    use_lu: bool = True
    seed: int = 0

    def _inner(self) -> InvertibleAffine:
        return InvertibleAffine(self.num_channels, use_lu=self.use_lu,
                                seed=self.seed)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return self._inner().init_params(generator, dtype=dtype,
                                         device=device)

    def _apply(self, params, z, inverse: bool):
        b, c, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, c)
        inner = self._inner()
        out, ld = (inner.inverse if inverse else inner.forward)(params, flat)
        z_ = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return z_, ld.reshape(b, h * w).sum(dim=-1)

    def forward(self, params, z):
        return self._apply(params, z, inverse=False)

    def inverse(self, params, z):
        return self._apply(params, z, inverse=True)
