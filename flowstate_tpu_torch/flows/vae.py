"""Encoders, decoders and the flow-augmented VAE.

Port of ``flowstate_tpu/flows/vae.py``: the encoders ``Dirac``,
``UniformEncoder``, ``ConstDiagGaussian`` and ``NNDiagGaussian`` (each
``(z, log q(z | x))`` for ``num_samples`` per input), the decoders
``NNDiagGaussianDecoder`` and ``NNBernoulliDecoder`` (``log p(x | z)``),
and ``NormalizingFlowVAE`` (:158-195), whose tree is JAX's
``{"encoder", "flows", "decoder"}``.

An encoder's draws are injectable: ``draw(x, num_samples, generator)``
gives its noise, (B, M, d) (uniform on [0, 1) for ``UniformEncoder``,
standard normal for the Gaussians, (B, M, 0) for ``Dirac``), and
``from_noise(params, x, noise)`` the samples; ``sample`` is the two in
turn.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flowstate_tpu_torch.flows.core import ParamTree, placement

LOG_2PI = math.log(2.0 * math.pi)


class _Encoder:
    """``sample`` as ``draw`` then ``from_noise``."""

    def sample(self, params, x, num_samples: int = 1,
               generator: Optional[torch.Generator] = None):
        return self.from_noise(params, x,
                               self.draw(x, num_samples, generator))


def _normal_noise(x, num_samples, dim, generator):
    return torch.randn((x.shape[0], num_samples, dim), generator=generator,
                       dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Dirac(_Encoder):
    """``z = x``."""

    def draw(self, x, num_samples: int = 1,
             generator: Optional[torch.Generator] = None):
        return x.new_zeros((x.shape[0], num_samples, 0))

    def from_noise(self, params, x, noise):
        z = x[:, None, :].expand(-1, noise.shape[1], -1)
        return z, x.new_zeros(z.shape[:2])

    def log_prob(self, params, z, x):
        return z.new_zeros(z.shape[:-1])


@dataclasses.dataclass(frozen=True)
class UniformEncoder(_Encoder):
    """Uniform on ``[zmin, zmax]^d`` whatever ``x``."""

    zmin: float = 0.0
    zmax: float = 1.0

    def draw(self, x, num_samples: int = 1,
             generator: Optional[torch.Generator] = None):
        return torch.rand((x.shape[0], num_samples, x.shape[1]),
                          generator=generator, dtype=x.dtype,
                          device=x.device)

    def from_noise(self, params, x, noise):
        z = self.zmin + (self.zmax - self.zmin) * noise
        log_q = -math.log(self.zmax - self.zmin) * x.shape[1]
        return z, torch.full(z.shape[:2], log_q, dtype=x.dtype,
                             device=x.device)

    def log_prob(self, params, z, x):
        return torch.full(z.shape[:-1],
                          -math.log(self.zmax - self.zmin) * z.shape[-1],
                          dtype=z.dtype, device=z.device)


@dataclasses.dataclass(frozen=True)
class ConstDiagGaussian(_Encoder):
    """``q(z | x) = N(loc, e^log_scale)``, the same for every ``x``."""

    dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"loc": torch.zeros((self.dim,), dtype=dtype, device=device),
                "log_scale": torch.zeros((self.dim,), dtype=dtype,
                                         device=device)}

    def draw(self, x, num_samples: int = 1,
             generator: Optional[torch.Generator] = None):
        return _normal_noise(x, num_samples, self.dim, generator)

    def from_noise(self, params, x, eps):
        z = params["loc"] + torch.exp(params["log_scale"]) * eps
        log_q = (-0.5 * self.dim * LOG_2PI
                 - torch.sum(params["log_scale"] + 0.5 * eps ** 2, dim=-1))
        return z, log_q

    def log_prob(self, params, z, x):
        eps = (z - params["loc"]) / torch.exp(params["log_scale"])
        return (-0.5 * self.dim * LOG_2PI
                - torch.sum(params["log_scale"] + 0.5 * eps ** 2, dim=-1))


@dataclasses.dataclass(frozen=True)
class NNDiagGaussian(_Encoder):
    """The amortised diagonal Gaussian: ``net(x)`` gives the mean (the
    first ``latent_dim`` outputs) and the log variance (the next)."""

    net: Any
    latent_dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self.net.init_params(generator, dtype=dtype,
                                            device=device)}

    def _moments(self, params, x):
        raw = self.net.apply(params["net"], x)
        d = self.latent_dim
        return raw[..., :d], torch.exp(0.5 * raw[..., d:2 * d])

    def draw(self, x, num_samples: int = 1,
             generator: Optional[torch.Generator] = None):
        return _normal_noise(x, num_samples, self.latent_dim, generator)

    def from_noise(self, params, x, eps):
        mean, std = self._moments(params, x)
        z = mean[:, None, :] + std[:, None, :] * eps
        log_q = (-0.5 * self.latent_dim * LOG_2PI
                 - torch.sum(torch.log(std)[:, None, :] + 0.5 * eps ** 2,
                             dim=-1))
        return z, log_q

    def log_prob(self, params, z, x):
        mean, std = self._moments(params, x)
        eps = (z - mean[:, None, :]) / std[:, None, :]
        return (-0.5 * self.latent_dim * LOG_2PI
                - torch.sum(torch.log(std)[:, None, :] + 0.5 * eps ** 2,
                            dim=-1))


@dataclasses.dataclass(frozen=True)
class NNDiagGaussianDecoder:
    """``p(x | z) = N(mean(z), e^log_var(z))`` from ``net(z)``."""

    net: Any
    data_dim: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self.net.init_params(generator, dtype=dtype,
                                            device=device)}

    def log_prob(self, params, x, z):
        raw = self.net.apply(params["net"], z)
        d = self.data_dim
        mean, log_var = raw[..., :d], raw[..., d:2 * d]
        return (-0.5 * d * LOG_2PI
                - torch.sum(0.5 * log_var
                            + 0.5 * (x - mean) ** 2 / torch.exp(log_var),
                            dim=-1))


@dataclasses.dataclass(frozen=True)
class NNBernoulliDecoder:
    """``p(x | z) = Bernoulli(sigmoid(net(z)))``."""

    net: Any

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self.net.init_params(generator, dtype=dtype,
                                            device=device)}

    def log_prob(self, params, x, z):
        logits = self.net.apply(params["net"], z)
        return torch.sum(x * F.logsigmoid(logits)
                         + (1 - x) * F.logsigmoid(-logits), dim=-1)


class NormalizingFlowVAE(nn.Module):
    """A VAE whose posterior samples pass through flow layers:
    ``forward`` encodes, pushes z through ``flows`` and scores it under
    the prior and the decoder, returning ``(z, log_q, log_p)``, each
    (B, M, ...).  The tree is ``{"encoder", "flows", "decoder"}`` (an
    empty dict for a part without parameters), drawn from
    ``generator``."""

    def __init__(self, prior, encoder, flows: Sequence[Any], decoder=None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.prior = prior
        self.encoder = encoder
        self.flows = tuple(flows)
        self.decoder = decoder
        kw = dict(dtype=dtype, device=device)

        def init(part):
            return (part.init_params(generator, **kw)
                    if hasattr(part, "init_params") else {})

        self.params = ParamTree({
            "encoder": init(encoder),
            "flows": [f.init_params(generator, **kw) for f in self.flows],
            "decoder": init(decoder)})
        self._placement = (torch.device(device), dtype)

    @property
    def device(self) -> torch.device:
        return placement(self)[0]

    def forward(self, x, num_samples: int = 1,
                generator: Optional[torch.Generator] = None):
        return self.forward_from_noise(
            x, self.encoder.draw(x, num_samples, generator))

    def forward_from_noise(self, x, noise):
        """``forward`` on the encoder's ``noise`` (its ``draw``)."""
        params = self.params.tree()
        z, log_q = self.encoder.from_noise(params["encoder"], x, noise)
        b, m, d = z.shape
        z = z.reshape(b * m, d)
        log_q = log_q.reshape(b * m)
        for flow, p in zip(self.flows, params["flows"]):
            z, log_det = flow.forward(p, z)
            log_q = log_q - log_det
        log_p = self.prior.log_prob(z)
        if self.decoder is not None:
            x_rep = torch.repeat_interleave(x, m, dim=0)
            log_p = log_p + self.decoder.log_prob(params["decoder"], x_rep, z)
        return (z.reshape(b, m, d), log_q.reshape(b, m),
                log_p.reshape(b, m))
