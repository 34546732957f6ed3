"""The conditional normalizing flow: every layer takes one context.

Port of ``flowstate_tpu/flows/models.py::ConditionalNormalizingFlow``
(:82-177), the blocked move's proposal (``mcmc/blocked.py``): a
context-free ``UniformParticle`` base over the block's coordinates and
layers whose ``forward`` / ``inverse`` take ``context``
(``flows/core.py::build_conditional_circular_flow``).  The JAX module's
``ContextAffineCoupling``, ``ClassCondFlow`` and ``MultiscaleFlow`` are
ROADMAP queue 1 item 14b.

Directions as in ``NormalizingFlow``: ``forward`` is latent -> data
(sampling), ``inverse`` data -> latent (log_prob).
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import torch
from torch import nn

from flowstate_tpu_torch.flows.core import ScannedLayers
from flowstate_tpu_torch.flows.distributions import UniformParticle


class ConditionalNormalizingFlow(nn.Module):
    """A chain of context-taking layers over a context-free base.

    ``context`` is (B, F), one row per sample; sampling takes an explicit
    ``torch.Generator`` on the flow's device."""

    def __init__(self, base: UniformParticle, layers: Sequence[nn.Module]):
        super().__init__()
        self.base = base
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward_and_log_det(self, z: torch.Tensor, context=None):
        log_det = torch.zeros_like(z[:, 0])
        for layer in self.layers:
            z, ld = layer.forward(z, context)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, x: torch.Tensor, context=None):
        log_det = torch.zeros_like(x[:, 0])
        for layer in reversed(self.layers):
            x, ld = layer.inverse(x, context)
            log_det = log_det + ld
        return x, log_det

    def log_prob(self, x: torch.Tensor, context=None) -> torch.Tensor:
        z, log_q = self.inverse_and_log_det(x, context)
        return log_q + self.base.log_prob(z)

    def forward_kld(self, x: torch.Tensor, context=None) -> torch.Tensor:
        """The conditional maximum-likelihood loss ``-mean(log q(x | c))``
        (the base term included, as the JAX loss has it)."""
        return -torch.mean(self.log_prob(x, context))

    def base_sample(self, num_samples: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return self.base.sample(num_samples, generator,
                                self.device).to(self.dtype)

    def push_forward(self, z: torch.Tensor, context=None):
        """Base points ``z`` to samples: ``(x, log q(x | context))``."""
        x, log_det = self.forward_and_log_det(z, context)
        return x, self.base.log_prob(z) - log_det

    def push_forward_with_old(self, z: torch.Tensor, x_old: torch.Tensor,
                              context=None, paired: bool = True):
        """``(x_new, log_q_new, log_q_old)`` for base points ``z`` and the
        current points ``x_old``: on a single ``ScannedLayers`` with
        ``paired`` the two sweeps run in one paired loop, else as
        separate passes."""
        if (paired and len(self.layers) == 1
                and isinstance(self.layers[0], ScannedLayers)):
            (x_new, ld_f), (z_old, ld_i) = (
                self.layers[0].paired_forward_inverse(z, x_old, context))
            return (x_new, self.base.log_prob(z) - ld_f,
                    ld_i + self.base.log_prob(z_old))
        x_new, log_q_new = self.push_forward(z, context)
        return x_new, log_q_new, self.log_prob(x_old, context)

    def sample_and_log_prob(self, num_samples: int,
                            generator: Optional[torch.Generator] = None,
                            context=None):
        """Samples and their log q(x | context) in one forward pass."""
        return self.push_forward(self.base_sample(num_samples, generator),
                                 context)

    def sample_and_log_prob_with_old(self, num_samples: int,
                                     x_old: torch.Tensor,
                                     generator: Optional[torch.Generator]
                                     = None, context=None):
        """``(x_new, log_q_new, log_q_old)``: the blocked move's flow
        work, paired on a single ``ScannedLayers``."""
        return self.push_forward_with_old(
            self.base_sample(num_samples, generator), x_old, context)

    def save(self, path: str) -> None:
        """A pickle of the JAX package's parameter layout (numpy arrays),
        which ``flows.convert.params_from_jax`` and the JAX
        ``ConditionalNormalizingFlow.load`` both read."""
        from flowstate_tpu_torch.flows.convert import params_to_jax

        with open(path, "wb") as f:
            pickle.dump(params_to_jax(self), f)

    def load(self, path: str) -> "ConditionalNormalizingFlow":
        """Load a file ``save`` (of either package) wrote; only files this
        program or its users wrote, since unpickling runs code."""
        from flowstate_tpu_torch.flows.convert import params_from_jax

        with open(path, "rb") as f:
            return params_from_jax(pickle.load(f), self)
