"""Periodic coordinate flows: ``PeriodicWrap`` and ``PeriodicShift``.

Port of ``flowstate_tpu/flows/periodic.py``: ``PeriodicWrap`` wraps the
coordinates ``ind`` back into [-bound, bound) on the inverse pass,
``PeriodicShift`` shifts and wraps them.  Both preserve volume (log-det
0).  JAX's wrap (:23) is ``jnp.mod``, floored, so the port's is
``torch.remainder`` (``torch.fmod`` truncates and would leave negative
coordinates below -bound).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from flowstate_tpu_torch.flows.base import ParameterFree


def _wrap(x, bound, shift=0.0):
    return torch.remainder(x + shift + bound, 2.0 * bound) - bound


def _set(z, ind, values):
    z = z.clone()
    z[..., list(ind)] = values
    return z


@dataclasses.dataclass(frozen=True)
class PeriodicWrap(ParameterFree):
    ind: Tuple[int, ...]
    bound: float = 1.0

    def forward(self, params, z):
        return z, torch.zeros_like(z[:, 0])

    def inverse(self, params, z):
        idx = list(self.ind)
        return (_set(z, idx, _wrap(z[..., idx], self.bound)),
                torch.zeros_like(z[:, 0]))


@dataclasses.dataclass(frozen=True)
class PeriodicShift(ParameterFree):
    ind: Tuple[int, ...]
    bound: float = 1.0
    shift: float = 0.0

    def forward(self, params, z):
        idx = list(self.ind)
        return (_set(z, idx, _wrap(z[..., idx], self.bound, self.shift)),
                torch.zeros_like(z[:, 0]))

    def inverse(self, params, z):
        idx = list(self.ind)
        return (_set(z, idx, _wrap(z[..., idx], self.bound, -self.shift)),
                torch.zeros_like(z[:, 0]))
