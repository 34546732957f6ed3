"""Hamiltonian annealed importance sampling (HAIS).

Port of ``flowstate_tpu/flows/sampling.py::HAIS`` (:22-69): a schedule of
geometric interpolations between a prior and a target, each bridged by an
HMC transition (``flows/stochastic.py``), giving weighted samples whose
log-weights estimate log Z of the target (against a normalised prior).
``sample_from`` takes the prior's points and each layer's draws as
tensors; ``sample`` draws them from a generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from flowstate_tpu_torch.flows.stochastic import HamiltonianMonteCarlo
from flowstate_tpu_torch.flows.toy_targets import LinearInterpolation


@dataclasses.dataclass(frozen=True)
class HAIS:
    """``betas``: 1 = beta_0 > ... > beta_n = 0; the j-th intermediate
    density is target^beta_j prior^(1 - beta_j).  ``prior`` has
    ``sample(num_samples, generator, device)`` and ``log_prob(z)``."""

    betas: Tuple[float, ...]
    prior: Any
    target: Any
    num_leapfrog: int
    dim: int
    step_size: float = 0.1

    def _layers(self) -> List[HamiltonianMonteCarlo]:
        n = len(self.betas) - 1
        return [HamiltonianMonteCarlo(
            target=LinearInterpolation(self.target, self.prior,
                                       float(self.betas[i])),
            steps=self.num_leapfrog, dim=self.dim)
            for i in range(n - 1, 0, -1)]

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        params = []
        for layer in self._layers():
            p = layer.init_params(generator, dtype=dtype, device=device)
            p["log_step_size"] = torch.full(
                (self.dim,), math.log(self.step_size), dtype=dtype,
                device=device)
            params.append(p)
        return params

    def sample_from(self, params, samples: torch.Tensor,
                    draws: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        """Weighted samples from the prior's ``samples`` and each layer's
        ``(momentum noise, uniforms)``: ``(samples, log_weights)``."""
        log_weights = -self.prior.log_prob(samples)
        for layer, p, (noise, u) in zip(self._layers(), params, draws):
            samples, lw = layer.run(p, samples, noise, u)
            log_weights = log_weights + lw
        return samples, log_weights + self.target.log_prob(samples)

    def sample(self, params, num_samples: int,
               generator: Optional[torch.Generator] = None, device="cuda"):
        """``(samples, log_weights)`` with every draw from ``generator``:
        the prior's points, then each layer's."""
        samples = self.prior.sample(num_samples, generator, device)
        if params:
            samples = samples.to(params[0]["log_mass"].dtype)
        draws = [layer.draw(samples, generator) for layer in self._layers()]
        return self.sample_from(params, samples, draws)
