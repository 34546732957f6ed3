"""Base distributions of the flows.

Port of ``flowstate_tpu/flows/distributions.py``:

* ``UniformParticle`` (:31): uniform on the torus
  ``[-bound, bound]^(n_particles * n_dim)``, the hybrid runs' base;
* ``UniformBase`` (:59): uniform on ``[low, high]^dim``;
* ``DiagGaussian`` (:77): a diagonal Gaussian, ``loc`` and ``log_scale``;
* ``UniformGaussian`` (:105): uniform on some indices, Gaussian on the
  rest, with the fork's semantics by default (``fork_semantics=True``,
  :130-157: ``sample`` draws uniform noise on both groups and
  ``log_prob`` returns the uniform part only);
* ``GaussianMixture`` (:162), ``ClassCondDiagGaussian`` (:195),
  ``GlowBase`` (:232, per channel on (C, H, W)), ``AffineGaussian``
  (:276) and ``GaussianPCA`` (:299).

Bases are configurations without tensors.  ``sample(num_samples,
generator, device)`` draws float32 from an explicit generator (the
class-conditional base takes its labels ``y`` after the count), and
``log_prob(z)`` follows ``z``'s dtype.  A trainable base takes its tree
as ``params``; without one it is at its init (standard normal), which is
how ``NormalizingFlow`` calls it, as JAX's does: the flow trains its
layers only.  ``GaussianMixture`` and ``GaussianPCA`` have no default
tree and need ``params``.  ``ParamLayer`` holds a base's tree for a
caller that trains it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


def _uniform(shape, low, high, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return low + (high - low) * u


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _in_box(z, low, high):
    return torch.all((z >= low) & (z <= high), dim=-1)


@dataclasses.dataclass(frozen=True)
class UniformParticle:
    """``log_prob`` is ``-D log(2 bound)`` inside the bounds and ``-inf``
    outside."""

    n_particles: int
    n_dim: int
    bound: float

    @property
    def dim(self) -> int:
        return self.n_particles * self.n_dim

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        u = torch.rand((num_samples, self.dim), generator=generator,
                       dtype=torch.float32, device=device)
        return -self.bound + (2.0 * self.bound) * u

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        in_bounds = torch.all((z >= -self.bound) & (z <= self.bound), dim=-1)
        const = -self.dim * math.log(2.0 * self.bound)
        return torch.where(in_bounds, torch.full_like(z[:, 0], const),
                           torch.full_like(z[:, 0], -math.inf))


@dataclasses.dataclass(frozen=True)
class UniformBase:
    """Uniform on the box ``[low, high]^dim``."""

    dim: int
    low: float = -1.0
    high: float = 1.0

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        return _uniform((num_samples, self.dim), self.low, self.high,
                        generator, device)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        const = -self.dim * math.log(self.high - self.low)
        return torch.where(_in_box(z, self.low, self.high),
                           torch.full_like(z[:, 0], const),
                           torch.full_like(z[:, 0], -math.inf))


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """A diagonal Gaussian with ``loc`` and ``log_scale`` (``trainable``
    is kept for the reference's signature: the tree is trained only by a
    caller that passes it)."""

    dim: int
    trainable: bool = True

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"loc": torch.zeros((self.dim,), dtype=dtype, device=device),
                "log_scale": torch.zeros((self.dim,), dtype=dtype,
                                         device=device)}

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda",
               params=None) -> torch.Tensor:
        eps = _normal((num_samples, self.dim), generator, device)
        if params is None:
            return eps
        return params["loc"] + torch.exp(params["log_scale"]) * eps

    def log_prob(self, z: torch.Tensor, params=None) -> torch.Tensor:
        if params is None:
            params = self.init_params(dtype=z.dtype, device=z.device)
        log_scale = params["log_scale"]
        z_std = (z - params["loc"]) * torch.exp(-log_scale)
        return (-0.5 * self.dim * LOG_2PI - torch.sum(log_scale)
                - 0.5 * torch.sum(z_std ** 2, dim=-1))


@dataclasses.dataclass(frozen=True)
class UniformGaussian:
    """Uniform on ``ind_uniform`` (width ``scale``, centred), Gaussian on
    the rest; the fork's semantics unless ``fork_semantics=False``."""

    dim: int
    ind_uniform: Tuple[int, ...]
    scale: Optional[Tuple[float, ...]] = None
    fork_semantics: bool = True

    def _split(self):
        ind_u = np.asarray(self.ind_uniform, dtype=np.int64)
        ind_g = np.asarray([i for i in range(self.dim)
                            if i not in set(self.ind_uniform)],
                           dtype=np.int64)
        return ind_u, ind_g

    def _scales(self, dtype, device):
        if self.scale is None:
            return torch.ones((self.dim,), dtype=dtype, device=device)
        return torch.as_tensor(self.scale, dtype=dtype, device=device)

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
        ind_u, ind_g = self._split()
        scales = self._scales(torch.float32, device)
        out = torch.zeros((num_samples, self.dim), dtype=torch.float32,
                          device=device)
        u = _uniform((num_samples, len(ind_u)), -0.5, 0.5, generator, device)
        out[:, ind_u] = u * scales[ind_u]
        if len(ind_g):
            if self.fork_semantics:
                g = _uniform((num_samples, len(ind_g)), -0.5, 0.5, generator,
                             device)
            else:
                g = _normal((num_samples, len(ind_g)), generator, device)
            out[:, ind_g] = g * scales[ind_g]
        return out

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        ind_u, ind_g = self._split()
        scales = self._scales(z.dtype, z.device)
        log_u = (-torch.sum(torch.log(scales[ind_u]))).expand(z.shape[:-1])
        if self.fork_semantics or len(ind_g) == 0:
            return log_u
        zg = z[..., ind_g] / scales[ind_g]
        log_g = (-0.5 * len(ind_g) * LOG_2PI
                 - torch.sum(torch.log(scales[ind_g]))
                 - 0.5 * torch.sum(zg ** 2, dim=-1))
        return log_u + log_g


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """A mixture of ``n_modes`` diagonal Gaussians; ``params`` (``loc``,
    ``log_scale``, ``weight_logits``) is required."""

    n_modes: int
    dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda",
                    loc_scale: float = 1.0):
        kw = dict(dtype=dtype, device=device)
        return {"loc": loc_scale * torch.randn((self.n_modes, self.dim),
                                               generator=generator, **kw),
                "log_scale": torch.zeros((self.n_modes, self.dim), **kw),
                "weight_logits": torch.zeros((self.n_modes,), **kw)}

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda",
               params=None) -> torch.Tensor:
        probs = torch.softmax(params["weight_logits"].float(), dim=-1)
        mode = torch.multinomial(probs.to(device), num_samples,
                                 replacement=True, generator=generator)
        eps = _normal((num_samples, self.dim), generator, device)
        loc = params["loc"][mode]
        scale = torch.exp(params["log_scale"])[mode]
        return loc + scale * eps

    def log_prob(self, z: torch.Tensor, params=None) -> torch.Tensor:
        log_w = torch.log_softmax(params["weight_logits"], dim=-1)
        z_ = (z[..., None, :] - params["loc"]) * torch.exp(
            -params["log_scale"])
        comp = (-0.5 * self.dim * LOG_2PI
                - torch.sum(params["log_scale"], dim=-1)
                - 0.5 * torch.sum(z_ ** 2, dim=-1))
        return torch.logsumexp(log_w + comp, dim=-1)


@dataclasses.dataclass(frozen=True)
class ClassCondDiagGaussian:
    """A diagonal Gaussian per class; ``y`` is one-hot (B, num_classes)
    and ``temperature`` scales the deviation."""

    dim: int
    num_classes: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        shape = (self.num_classes, self.dim)
        return {"loc": torch.zeros(shape, dtype=dtype, device=device),
                "log_scale": torch.zeros(shape, dtype=dtype, device=device)}

    def _moments(self, y, params, temperature):
        if params is None:
            params = self.init_params(dtype=y.dtype, device=y.device)
        loc = y @ params["loc"]
        log_scale = y @ params["log_scale"]
        if temperature is not None:
            log_scale = log_scale + math.log(temperature)
        return loc, log_scale

    def sample(self, num_samples: int, y: torch.Tensor,
               generator: Optional[torch.Generator] = None, params=None,
               temperature: Optional[float] = None) -> torch.Tensor:
        loc, log_scale = self._moments(y, params, temperature)
        eps = _normal((num_samples, self.dim), generator, y.device)
        return loc + torch.exp(log_scale) * eps

    def log_prob(self, z: torch.Tensor, y: torch.Tensor, params=None,
                 temperature: Optional[float] = None) -> torch.Tensor:
        loc, log_scale = self._moments(y, params, temperature)
        return (-0.5 * self.dim * LOG_2PI
                - torch.sum(log_scale
                            + 0.5 * ((z - loc) / torch.exp(log_scale)) ** 2,
                            dim=-1))


@dataclasses.dataclass(frozen=True)
class GlowBase:
    """Glow's base: a Gaussian on (C, H, W) with a ``loc`` and a
    ``log_scale`` per channel, the stored values times
    ``logscale_factor``; ``temperature`` scales the deviation."""

    shape: Tuple[int, ...]   # (C, H, W)
    logscale_factor: float = 3.0

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        c = self.shape[0]
        return {"loc": torch.zeros((c,), dtype=dtype, device=device),
                "log_scale_raw": torch.zeros((c,), dtype=dtype,
                                             device=device)}

    def _moments(self, params, temperature, dtype, device):
        if params is None:
            params = self.init_params(dtype=dtype, device=device)
        bshape = (1, self.shape[0]) + (1,) * (len(self.shape) - 1)
        loc = (params["loc"] * self.logscale_factor).reshape(bshape)
        log_scale = (params["log_scale_raw"] * self.logscale_factor
                     ).reshape(bshape)
        if temperature is not None:
            log_scale = log_scale + math.log(temperature)
        return loc, log_scale

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda",
               params=None, temperature: Optional[float] = None
               ) -> torch.Tensor:
        loc, log_scale = self._moments(params, temperature, torch.float32,
                                       device)
        eps = _normal((num_samples, *self.shape), generator, device)
        return loc + torch.exp(log_scale) * eps

    def log_prob(self, z: torch.Tensor, params=None,
                 temperature: Optional[float] = None) -> torch.Tensor:
        loc, log_scale = self._moments(params, temperature, z.dtype,
                                       z.device)
        num_pix = float(np.prod(self.shape[1:]))
        axes = tuple(range(1, len(self.shape) + 1))
        return (-0.5 * float(np.prod(self.shape)) * LOG_2PI
                - num_pix * torch.sum(log_scale)
                - 0.5 * torch.sum(((z - loc) / torch.exp(log_scale)) ** 2,
                                  dim=axes))


@dataclasses.dataclass(frozen=True)
class AffineGaussian:
    """``z = e^s * eps`` with a trainable ``s`` per dimension."""

    dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"s": torch.zeros((self.dim,), dtype=dtype, device=device)}

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda",
               params=None) -> torch.Tensor:
        eps = _normal((num_samples, self.dim), generator, device)
        return eps if params is None else torch.exp(params["s"]) * eps

    def log_prob(self, z: torch.Tensor, params=None) -> torch.Tensor:
        if params is None:
            params = self.init_params(dtype=z.dtype, device=z.device)
        eps = z * torch.exp(-params["s"])
        return (-0.5 * self.dim * LOG_2PI - torch.sum(params["s"])
                - 0.5 * torch.sum(eps ** 2, dim=-1))


@dataclasses.dataclass(frozen=True)
class GaussianPCA:
    """The low-rank Gaussian ``z = eps W + loc`` with isotropic noise
    ``sigma`` in its density; ``params`` (``W``, ``loc``) is required."""

    dim: int
    latent_dim: int
    sigma: float = 0.1

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"W": 0.1 * torch.randn((self.latent_dim, self.dim),
                                       generator=generator, dtype=dtype,
                                       device=device),
                "loc": torch.zeros((self.dim,), dtype=dtype, device=device)}

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda",
               params=None) -> torch.Tensor:
        eps = _normal((num_samples, self.latent_dim), generator, device)
        return params["loc"] + eps.to(params["W"].dtype) @ params["W"]

    def log_prob(self, z: torch.Tensor, params=None) -> torch.Tensor:
        w = params["W"]
        cov = w.T @ w + self.sigma ** 2 * torch.eye(
            self.dim, dtype=w.dtype, device=w.device)
        diff = z - params["loc"]
        sol = torch.linalg.solve(cov, diff.T).T
        logdet = torch.linalg.slogdet(cov)[1]
        return (-0.5 * self.dim * LOG_2PI - 0.5 * logdet
                - 0.5 * torch.sum(diff * sol, dim=-1))
