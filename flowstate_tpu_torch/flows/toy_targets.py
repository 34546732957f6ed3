"""2-D toy targets and energy-landscape priors, for testing and demos.

Port of ``flowstate_tpu/flows/toy_targets.py``: ``TwoMoons``,
``CircularGaussianMixture``, ``RingMixture``, ``ConditionalDiagGaussian``,
``TwoIndependent``, ``TwoModes``, ``Sinusoidal`` and its gap and split
forms, ``Smiley``, ``ImagePrior`` (:245) and ``LinearInterpolation``
(:287).  Each has ``log_prob(z)`` on (B, 2) batches; the samplable ones
``sample(num_samples, generator, device)``.  ``rejection_sample`` and
``_take_accepted`` (:31-62) draw ``oversample * num_samples`` uniform
proposals in one batch and return exactly ``num_samples`` of the
accepted ones (cycling through them on a shortfall), a fixed shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch


def _take_accepted(z: torch.Tensor, accept: torch.Tensor,
                   num_samples: int) -> torch.Tensor:
    """The first ``num_samples`` accepted proposals, cycling through the
    accepted set on a shortfall (proposal 0 repeats if none is
    accepted)."""
    order = torch.argsort((~accept).to(torch.int8), stable=True)
    n_acc = torch.clamp(torch.sum(accept), min=1)
    pick = torch.remainder(torch.arange(num_samples, device=z.device), n_acc)
    return z[order[pick]]


def rejection_sample(target, num_samples: int,
                     generator: Optional[torch.Generator] = None,
                     device="cuda", prop_scale: float = 6.0,
                     prop_shift: float = -3.0, max_log_prob: float = 0.0,
                     oversample: int = 16) -> torch.Tensor:
    """Rejection sampling from uniform proposals on
    ``prop_shift + prop_scale [0, 1)^d``."""
    n_prop = oversample * num_samples
    z = prop_shift + prop_scale * torch.rand(
        (n_prop, target.n_dims), generator=generator, device=device)
    prob = torch.rand((n_prop,), generator=generator, device=device)
    accept = torch.exp(target.log_prob(z) - max_log_prob) > prob
    return _take_accepted(z, accept, num_samples)


def _norm(z, dim=1):
    return torch.linalg.norm(z, dim=dim)


@dataclasses.dataclass(frozen=True)
class TwoMoons:
    """The bimodal crescent."""

    n_dims: int = 2
    max_log_prob: float = 0.0

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        a = torch.abs(z[:, 0])
        return (-0.5 * ((_norm(z) - 2) / 0.2) ** 2
                - 0.5 * ((a - 2) / 0.3) ** 2
                + torch.log1p(torch.exp(-4 * a / 0.09)))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        return rejection_sample(self, num_samples, generator, device)


@dataclasses.dataclass(frozen=True)
class CircularGaussianMixture:
    """``n_modes`` Gaussians on the circle of radius 2."""

    n_modes: int = 8
    n_dims: int = 2

    @property
    def scale(self) -> float:
        return float(2 / 3 * np.sin(np.pi / self.n_modes))

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        i = torch.arange(self.n_modes, dtype=z.dtype, device=z.device)
        phi = 2 * math.pi / self.n_modes * i
        locs = torch.stack([2 * torch.sin(phi), 2 * torch.cos(phi)], dim=1)
        d = (torch.sum((z[:, None, :] - locs) ** 2, dim=-1)
             / (2 * self.scale ** 2))
        return (-math.log(2 * math.pi * self.scale ** 2 * self.n_modes)
                + torch.logsumexp(-d, dim=1))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        eps = torch.randn((num_samples, 2), generator=generator,
                          device=device)
        mode = torch.randint(0, self.n_modes, (num_samples,),
                             generator=generator, device=device)
        phi = 2 * math.pi / self.n_modes * mode.to(torch.float32)
        loc = torch.stack([2 * torch.sin(phi), 2 * torch.cos(phi)], dim=1)
        return eps * self.scale + loc


@dataclasses.dataclass(frozen=True)
class RingMixture:
    """``n_rings`` concentric rings."""

    n_rings: int = 2
    n_dims: int = 2
    max_log_prob: float = 0.0

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        scale = 1 / 4 / self.n_rings
        r = _norm(z)
        i = torch.arange(1, self.n_rings + 1, dtype=z.dtype, device=z.device)
        d = ((r[:, None] - 2 / self.n_rings * i) ** 2) / (2 * scale ** 2)
        return torch.logsumexp(-d, dim=1)

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        return rejection_sample(self, num_samples, generator, device)


@dataclasses.dataclass(frozen=True)
class ConditionalDiagGaussian:
    """A Gaussian whose mean and deviation are the context's halves."""

    def log_prob(self, z, context):
        d = z.shape[-1]
        loc, scale = context[:, :d], context[:, d:]
        return (-0.5 * d * math.log(2 * math.pi)
                - torch.sum(torch.log(scale)
                            + 0.5 * ((z - loc) / scale) ** 2, dim=-1))

    def sample(self, num_samples: int, context,
               generator: Optional[torch.Generator] = None):
        d = context.shape[-1] // 2
        loc, scale = context[:, :d], context[:, d:]
        eps = torch.randn((num_samples, d), generator=generator,
                          dtype=context.dtype, device=context.device)
        return loc + scale * eps


@dataclasses.dataclass(frozen=True)
class TwoIndependent:
    """Two independent targets on the coordinates before and after
    ``split``."""

    target1: Any
    target2: Any
    split: int

    def log_prob(self, z):
        return (self.target1.log_prob(z[:, :self.split])
                + self.target2.log_prob(z[:, self.split:]))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda"):
        return torch.cat([self.target1.sample(num_samples, generator, device),
                          self.target2.sample(num_samples, generator,
                                              device)], dim=1)


@dataclasses.dataclass(frozen=True)
class TwoModes:
    loc: float
    scale: float

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        a = torch.abs(z[:, 0])
        eps = abs(self.loc)
        return (-0.5 * ((_norm(z) - self.loc) / (2 * self.scale)) ** 2
                - 0.5 * ((a - eps) / (3 * self.scale)) ** 2
                + torch.log1p(torch.exp(-2 * (a * eps)
                                        / (3 * self.scale) ** 2)))


def _coords(z):
    return torch.movedim(z, -1, 0) if z.dim() > 1 else z


def _norm4(z_):
    return torch.sum(torch.abs(z_) ** 4, dim=0) ** 0.25


@dataclasses.dataclass(frozen=True)
class Sinusoidal:
    scale: float
    period: float

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        z_ = _coords(z)
        w1 = torch.sin(2 * math.pi / self.period * z_[0])
        return (-0.5 * ((z_[1] - w1) / self.scale) ** 2
                - 0.5 * (_norm4(z_) / (20 * self.scale)) ** 4)


@dataclasses.dataclass(frozen=True)
class SinusoidalGap:
    scale: float
    period: float

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        z_ = _coords(z)
        w1 = torch.sin(2 * math.pi / self.period * z_[0])
        w2 = 3 * torch.exp(-0.5 * ((z_[0] - 1) / 0.6) ** 2)
        eps = 1e-12
        a = -0.5 * ((z_[1] - w1) / self.scale) ** 2
        b = -0.5 * ((z_[1] - w1 + w2) / self.scale) ** 2
        return (torch.logaddexp(a, b)
                - 0.5 * (_norm4(z_) / (20 * self.scale)) ** 4 + eps)


@dataclasses.dataclass(frozen=True)
class SinusoidalSplit:
    scale: float
    period: float

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        z_ = _coords(z)
        w1 = torch.sin(2 * math.pi / self.period * z_[0])
        w3 = 3 * torch.sigmoid((z_[0] - 1) / 0.3)
        a = -0.5 * ((z_[1] - w1) / self.scale) ** 2
        b = -0.5 * ((z_[1] - w1 + w3) / self.scale) ** 2
        return (torch.logaddexp(a, b)
                - 0.5 * (_norm4(z_) / (20 * self.scale)) ** 4)


@dataclasses.dataclass(frozen=True)
class Smiley:
    scale: float

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        z_ = _coords(z)
        return (-0.5 * ((_norm(z, -1) - 1.2) / (2 * self.scale)) ** 2
                - 0.5 * ((torch.abs(z_[1] + 0.8) - 1.2)
                         / (2 * self.scale)) ** 2)


class ImagePrior:
    """A density on the rectangle ``x_range x y_range`` from a grayscale
    image's (normalised, eps-floored) intensities: ``log_prob`` looks up
    the nearest pixel, ``sample`` rejects uniform points against the
    intensity in one fixed-size batch."""

    def __init__(self, image, x_range=(-3.0, 3.0), y_range=(-3.0, 3.0),
                 eps: float = 1e-10, device="cuda"):
        img = np.flip(np.asarray(image, dtype=np.float64), 0).T + eps
        img = img / img.max()
        self.image = torch.as_tensor(img, dtype=torch.float32, device=device)
        self.density = torch.as_tensor(np.log(img / img.sum()),
                                       dtype=torch.float32, device=device)
        self.shape = np.asarray(img.shape)
        self.shift = torch.as_tensor([x_range[0], y_range[0]],
                                     dtype=torch.float64, device=device)
        self.scale = torch.as_tensor([x_range[1] - x_range[0],
                                      y_range[1] - y_range[0]],
                                     dtype=torch.float64, device=device)

    def _index(self, z_):
        top = torch.as_tensor(self.shape - 1, dtype=z_.dtype,
                              device=z_.device)
        return (z_ * top).to(torch.int64)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        z_ = torch.clamp((z - self.shift.to(z.dtype)) / self.scale.to(z.dtype),
                         0.0, 1.0)
        ind = self._index(z_)
        return self.density[ind[:, 0], ind[:, 1]]

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               oversample: int = 8) -> torch.Tensor:
        """Per round the acceptance is mean(img) / max(img); raise
        ``oversample`` for mostly dark images (a shortfall cycles through
        the accepted points)."""
        device = self.image.device
        n_prop = oversample * num_samples
        z_ = torch.rand((n_prop, 2), generator=generator, device=device)
        ind = self._index(z_)
        intensity = self.image[ind[:, 0], ind[:, 1]]
        accept = intensity > torch.rand((n_prop,), generator=generator,
                                        device=device)
        return (_take_accepted(z_, accept, num_samples)
                * self.scale.to(z_.dtype) + self.shift.to(z_.dtype))


@dataclasses.dataclass(frozen=True)
class LinearInterpolation:
    """``alpha log p1 + (1 - alpha) log p2``, the geometric
    interpolation of two densities."""

    dist1: Any
    dist2: Any
    alpha: float

    def log_prob(self, z):
        return (self.alpha * self.dist1.log_prob(z)
                + (1.0 - self.alpha) * self.dist2.log_prob(z))
