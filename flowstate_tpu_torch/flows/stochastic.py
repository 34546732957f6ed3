"""Stochastic flow layers: MCMC transitions inside a flow.

Port of ``flowstate_tpu/flows/stochastic.py``:

* ``DiagGaussianProposal``: a diagonal-Gaussian random walk;
* ``MetropolisHastings`` (:47-81): ``steps`` MH transitions toward the
  target, the log-det adding ``log p(z) - log p(z')`` per accepted step
  (the stochastic flow's weight bookkeeping);
* ``HamiltonianMonteCarlo`` (:84-126): one leapfrog trajectory of
  ``steps`` steps with a trainable step size and mass, then an MH test.
  JAX's gradient (:96-100) is ``jax.grad`` of one point's log density
  under ``vmap``; here it is ``torch.autograd.grad`` of the summed
  ``log_prob``, the same per point, clipped to ``max_abs_grad`` alike.

Each layer is split in two: ``run`` takes its noise as tensors, and
``forward(params, z, generator)`` draws that noise from a generator and
calls it, so a test can give both packages the same draws.  ``inverse``
is the same transition, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DiagGaussianProposal:
    """``z' = z + eps e^log_scale``; symmetric, so its log-ratio is 0."""

    dim: int
    scale: float = 0.1

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"log_scale": torch.full((self.dim,), math.log(self.scale),
                                        dtype=dtype, device=device)}

    def draw(self, z: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The proposal's noise ``eps`` for ``z``."""
        return torch.randn(z.shape, generator=generator, dtype=z.dtype,
                           device=z.device)

    def propose(self, params, z, eps):
        """``(z', log q(z | z') - log q(z' | z))`` for the noise ``eps``."""
        return (z + eps * torch.exp(params["log_scale"]),
                torch.zeros_like(z[:, 0]))


@dataclasses.dataclass(frozen=True)
class MetropolisHastings:
    """``steps`` MH transitions; ``target`` has ``log_prob(z)``,
    ``proposal`` ``init_params``, ``draw`` and ``propose``."""

    target: Any
    proposal: Any
    steps: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"proposal": self.proposal.init_params(
            generator, dtype=dtype, device=device)}

    def run(self, params, z, noises: Sequence[torch.Tensor],
            uniforms: Sequence[torch.Tensor]):
        """The transitions on the given draws: step ``s`` proposes with
        ``noises[s]`` and accepts where ``uniforms[s] <= min(1, ratio)``."""
        log_det = torch.zeros_like(z[:, 0])
        log_p = self.target.log_prob(z)
        for eps, w in zip(noises, uniforms):
            z_, log_p_diff = self.proposal.propose(params["proposal"], z, eps)
            log_p_ = self.target.log_prob(z_)
            w_accept = torch.clamp(torch.exp(log_p_ - log_p + log_p_diff),
                                   max=1.0)
            accept = w <= w_accept
            z = torch.where(accept[:, None], z_, z)
            log_det = torch.where(accept, log_det + log_p - log_p_, log_det)
            log_p = torch.where(accept, log_p_, log_p)
        return z, log_det

    def forward(self, params, z, generator: Optional[torch.Generator] = None):
        noises, uniforms = [], []
        for _ in range(self.steps):
            noises.append(self.proposal.draw(z, generator))
            uniforms.append(torch.rand(z.shape[:1], generator=generator,
                                       dtype=z.dtype, device=z.device))
        return self.run(params, z, noises, uniforms)

    def inverse(self, params, z, generator: Optional[torch.Generator] = None):
        return self.forward(params, z, generator)


@dataclasses.dataclass(frozen=True)
class HamiltonianMonteCarlo:
    """One HMC trajectory of ``steps`` leapfrog steps toward ``target``
    (``log_prob(z)``), step size ``exp(log_step_size)`` and mass
    ``exp(log_mass)`` per dimension."""

    target: Any
    steps: int
    dim: int
    max_abs_grad: Optional[float] = None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        kw = dict(dtype=dtype, device=device)
        return {"log_step_size": torch.full((self.dim,), math.log(0.1), **kw),
                "log_mass": torch.zeros((self.dim,), **kw)}

    def _grad_log_p(self, z):
        """d log p / dz per point; differentiable in turn when ``z`` is
        part of a graph (the trajectory depends on the parameters)."""
        with torch.enable_grad():
            x = z if z.requires_grad else z.detach().requires_grad_(True)
            grad, = torch.autograd.grad(self.target.log_prob(x).sum(), x,
                                        create_graph=z.requires_grad)
        if self.max_abs_grad is not None:
            grad = torch.clamp(grad, -self.max_abs_grad, self.max_abs_grad)
        return grad

    def run(self, params, z, momentum_noise: torch.Tensor,
            u: torch.Tensor):
        """The trajectory from momentum ``momentum_noise e^(log_mass / 2)``
        and its MH test with uniforms ``u``: ``(z_out, log_det)``."""
        mass = torch.exp(params["log_mass"])
        step_size = torch.exp(params["log_step_size"])
        p = momentum_noise * torch.exp(0.5 * params["log_mass"])
        z_new, p_new = z, p
        for _ in range(self.steps):
            p_half = p_new + (step_size / 2.0) * self._grad_log_p(z_new)
            z_new = z_new + step_size * (p_half / mass)
            p_new = p_half + (step_size / 2.0) * self._grad_log_p(z_new)
        log_accept = (self.target.log_prob(z_new) - self.target.log_prob(z)
                      - 0.5 * torch.sum(p_new ** 2 / mass, dim=1)
                      + 0.5 * torch.sum(p ** 2 / mass, dim=1))
        accept = u < torch.exp(log_accept)
        z_out = torch.where(accept[:, None], z_new, z)
        return z_out, self.target.log_prob(z) - self.target.log_prob(z_out)

    def draw(self, z: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """``(momentum noise, uniforms)`` for one trajectory from ``z``."""
        return (torch.randn(z.shape, generator=generator, dtype=z.dtype,
                            device=z.device),
                torch.rand(z.shape[:1], generator=generator, dtype=z.dtype,
                           device=z.device))

    def forward(self, params, z, generator: Optional[torch.Generator] = None):
        return self.run(params, z, *self.draw(z, generator))

    def inverse(self, params, z, generator: Optional[torch.Generator] = None):
        return self.forward(params, z, generator)
