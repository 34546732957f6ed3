"""Flow-library utilities: an evaluation metric, data transforms, geometry.

Port of ``flowstate_tpu/flows/utils.py`` (:21-112): ``bits_per_dim`` and
``bits_per_dim_dataset``, the dataloader transforms ``Logit``, ``Jitter``
and ``Scale``, ``compute_distances``, ``distances_from_vectors`` and
``remove_mean``; ``sum_except_batch`` is re-exported from the couplings.
The port's models hold their parameters, so ``bits_per_dim`` takes the
model alone where JAX takes ``(model, params)``; ``Jitter`` draws from a
``torch.Generator`` where JAX takes a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from flowstate_tpu_torch.flows.coupling import sum_except_batch  # noqa: F401


def bits_per_dim(model, x: torch.Tensor, trans: str = "logit",
                 trans_param=(0.05,)) -> torch.Tensor:
    """Bits per dimension of a batch under a logit-preprocessed image
    model (``model.log_prob(x)``)."""
    if trans != "logit":
        raise NotImplementedError(
            f"The transformation {trans} is not implemented.")
    dims = float(np.prod(x.shape[1:]))
    log_q = model.log_prob(x)
    sig = (sum_except_batch(F.logsigmoid(x) / math.log(2))
           + sum_except_batch(F.logsigmoid(-x) / math.log(2)))
    b = -log_q / dims / math.log(2) - math.log2(1 - trans_param[0]) + 8
    return b + sig / dims


def bits_per_dim_dataset(model, batches: Iterable[torch.Tensor]) -> float:
    """The mean bits per dimension over an iterable of batches, NaNs
    left out."""
    n, total = 0, 0.0
    for x in batches:
        b = bits_per_dim(model, x).detach().cpu().numpy()
        total += np.nansum(b)
        n += len(b) - np.sum(np.isnan(b))
    return float(total / n)


@dataclasses.dataclass(frozen=True)
class Logit:
    """``logit(alpha + (1 - alpha) x)`` and its inverse."""

    alpha: float = 0.0

    def __call__(self, x):
        x_ = self.alpha + (1 - self.alpha) * x
        return torch.log(x_ / (1 - x_))

    def inverse(self, x):
        return (torch.sigmoid(x) - self.alpha) / (1 - self.alpha)


@dataclasses.dataclass(frozen=True)
class Jitter:
    """Uniform dequantization noise of width ``scale``."""

    scale: float = 1.0 / 256

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)
        return x + u * self.scale


@dataclasses.dataclass(frozen=True)
class Scale:
    """A constant rescale."""

    scale: float = 255.0 / 256.0

    def __call__(self, x):
        return x * self.scale


def compute_distances(x: torch.Tensor, n_particles: int, n_dimensions: int,
                      remove_duplicates: bool = True) -> torch.Tensor:
    """All pair distances of particle configurations: (B, N (N - 1) / 2)
    over the upper triangle, or the (B, N, N) matrix."""
    x = x.reshape(-1, n_particles, n_dimensions)
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=1e-24))
    if remove_duplicates:
        iu, ju = np.triu_indices(n_particles, k=1)
        return dist[:, iu, ju]
    return dist


def distances_from_vectors(r: torch.Tensor, eps: float = 1e-6
                           ) -> torch.Tensor:
    """The (..., N, N) distances of (..., N, N, D) difference vectors,
    ``eps`` inside the square root."""
    return torch.sqrt(torch.sum(r * r, dim=-1) + eps)


def remove_mean(samples: torch.Tensor, n_particles: int,
                n_dimensions: int) -> torch.Tensor:
    """Configurations with their centre of mass moved to the origin."""
    shape = samples.shape
    x = samples.reshape(-1, n_particles, n_dimensions)
    x = x - torch.mean(x, dim=1, keepdim=True)
    return x.reshape(shape)
