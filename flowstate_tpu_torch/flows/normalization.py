"""Normalization flow layers: ``ActNorm`` and ``BatchNorm``.

Port of ``flowstate_tpu/flows/normalization.py``:

* ``ActNorm`` (:23): ``AffineConstFlow`` with the data-dependent init of
  Glow, an explicit ``init_params_from_data`` (:27-31); its standard
  deviation is ``jnp.std``'s, with ddof 0, so ``correction=0`` here
  (``torch.std`` defaults to 1);
* ``BatchNorm`` (:35): whitening by the batch's own statistics (ddof 1,
  as JAX's :43-48), forward only.
"""

from __future__ import annotations

import dataclasses

import torch

from flowstate_tpu_torch.flows.base import ParameterFree

from flowstate_tpu_torch.flows.affine import AffineConstFlow


@dataclasses.dataclass(frozen=True)
class ActNorm(AffineConstFlow):
    """``AffineConstFlow`` whose first batch chooses its parameters."""

    def init_params_from_data(self, z: torch.Tensor):
        """``(s, t)`` that map ``z`` to zero mean and unit deviation."""
        s = -torch.log(torch.std(z, dim=0, correction=0) + 1e-6)
        t = -torch.mean(z, dim=0) * torch.exp(s)
        return {"s": s, "t": t}


@dataclasses.dataclass(frozen=True)
class BatchNorm(ParameterFree):
    """``(z - mean) / sqrt(std^2 + eps)`` over the batch; no inverse."""

    eps: float = 1e-10

    def forward(self, params, z):
        mean = torch.mean(z, dim=0, keepdim=True)
        std = torch.std(z, dim=0, keepdim=True, correction=1)
        denom = torch.sqrt(std ** 2 + self.eps)
        log_det = -torch.sum(torch.log(denom))
        return (z - mean) / denom, log_det.expand(z.shape[0])

    def inverse(self, params, z):
        raise NotImplementedError(
            "BatchNorm uses batch statistics and has no pointwise inverse.")
