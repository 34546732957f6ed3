"""More flow models: the conditional flow and its context coupling, and
the class-conditional flow.

Port of ``flowstate_tpu/flows/models.py``:

* ``ContextAffineCoupling`` (:24-80): an affine coupling whose net sees
  the identity half and the context, scale ``sigmoid(s + 2) + 1e-3``;
* ``ConditionalNormalizingFlow`` (:82-177), the blocked move's proposal
  (``mcmc/blocked.py``): a context-free ``UniformParticle`` base over the
  block's coordinates and layers whose ``forward`` / ``inverse`` take
  ``context`` (``flows/core.py::build_conditional_circular_flow``);
* ``ClassCondFlow`` (:184-211): the class label reaches the base only;
* ``MultiscaleFlow`` (:213-295): the RealNVP / Glow multiscale model,
  levels of layers joined by ``Merge``s, a base a level.  Its tree is
  JAX's ``{"flows": ((level 0's layer trees), ...), "transform": tree or
  None}``; the bases are called without a tree, so they stay at their
  init, as JAX's.

Directions as in ``NormalizingFlow``: ``forward`` is latent -> data
(sampling), ``inverse`` data -> latent (log_prob).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional, Sequence

import torch
from torch import nn

from flowstate_tpu_torch.flows.nets import MLP

from flowstate_tpu_torch.flows.core import ScannedLayers, placement
from flowstate_tpu_torch.flows.distributions import UniformParticle


@dataclasses.dataclass(frozen=True)
class ContextAffineCoupling:
    """An affine coupling whose net (an ``MLP`` starting at zero output)
    sees ``[identity half, context]``; ``flip`` transforms the other
    half."""

    features: int
    context_features: int
    hidden_features: int = 64
    flip: bool = False

    def _split(self, z):
        half = self.features // 2
        if self.flip:
            return z[:, half:], z[:, :half]
        return z[:, :half], z[:, half:]

    def _join(self, ident, trans):
        if self.flip:
            return torch.cat([trans, ident], dim=-1)
        return torch.cat([ident, trans], dim=-1)

    def _net(self) -> MLP:
        half = self.features // 2
        out = 2 * (self.features - half)
        return MLP((half + self.context_features, self.hidden_features,
                    self.hidden_features, out), init_zeros=True)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self._net().init_params(generator, dtype=dtype,
                                               device=device)}

    def _shift_log_scale(self, params, ident, context):
        raw = self._net().apply(params["net"],
                                torch.cat([ident, context], dim=-1))
        shift, s = torch.chunk(raw, 2, dim=-1)
        return shift, torch.log(torch.sigmoid(s + 2.0) + 1e-3)

    def forward(self, params, z, context=None):
        ident, trans = self._split(z)
        shift, log_scale = self._shift_log_scale(params, ident, context)
        trans = trans * torch.exp(log_scale) + shift
        return self._join(ident, trans), torch.sum(log_scale, dim=-1)

    def inverse(self, params, x, context=None):
        ident, trans = self._split(x)
        shift, log_scale = self._shift_log_scale(params, ident, context)
        trans = (trans - shift) * torch.exp(-log_scale)
        return self._join(ident, trans), -torch.sum(log_scale, dim=-1)


class ConditionalNormalizingFlow(nn.Module):
    """A chain of context-taking layers over a context-free base.

    ``context`` is (B, F), one row per sample; sampling takes an explicit
    ``torch.Generator`` on the flow's device."""

    def __init__(self, base: UniformParticle, layers: Sequence[nn.Module],
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.base = base
        self.layers = nn.ModuleList(layers)
        self._placement = (torch.device(device), dtype)

    @property
    def device(self) -> torch.device:
        return placement(self)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self)[1]

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


class ClassCondFlow(nn.Module):
    """A chain of layers over a class-conditional base: ``log_prob(x, y)``
    and ``sample(num_samples, y, generator)`` hand the one-hot labels
    ``y`` to the base (``base.log_prob(z, y)``, ``base.sample(n, y,
    generator)``), not to the layers."""

    def __init__(self, base, layers: Sequence[nn.Module], device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.base = base
        self.layers = nn.ModuleList(layers)
        self._placement = (torch.device(device), dtype)

    @property
    def device(self) -> torch.device:
        return placement(self)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self)[1]

    def log_prob(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        log_q = torch.zeros_like(x[:, 0])
        z = x
        for layer in reversed(self.layers):
            z, ld = layer.inverse(z)
            log_q = log_q + ld
        return log_q + self.base.log_prob(z, y)

    def forward_kld(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return -torch.mean(self.log_prob(x, y))

    def sample(self, num_samples: int, y: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.base.sample(num_samples, y, generator).to(self.dtype)
        for layer in self.layers:
            z, _ = layer.forward(z)
        return z


class MultiscaleFlow(nn.Module):
    """Levels of layers over a base a level; level 0 is the deepest.
    ``flows`` are per-level sequences of layer modules (``ParamLayer``s),
    ``merges`` the ``Merge`` configurations that join level i - 1's output
    to level i's latent, ``transform`` an optional layer module on the
    data side.  ``forward`` is latents -> data (sampling), ``inverse``
    data -> latents (log_prob); ``y``, when given, goes to the bases."""

    def __init__(self, bases: Sequence[Any],
                 flows: Sequence[Sequence[nn.Module]],
                 merges: Sequence[Any], transform: Optional[nn.Module] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.bases = tuple(bases)
        self.flows = nn.ModuleList(nn.ModuleList(level) for level in flows)
        self.merges = tuple(merges)
        self.transform = transform
        self._placement = (torch.device(device), dtype)

    @property
    def device(self) -> torch.device:
        return placement(self)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self)[1]

    def forward_and_log_det(self, z_list: Sequence[torch.Tensor]):
        """Latents per level -> data, and the log-det."""
        z = z_list[0]
        log_det = z.new_zeros(z.shape[0])
        for i, level in enumerate(self.flows):
            if i > 0:
                z, ld = self.merges[i - 1].forward({}, [z, z_list[i]])
                log_det = log_det + ld
            for layer in level:
                z, ld = layer.forward(z)
                log_det = log_det + ld
        if self.transform is not None:
            z, ld = self.transform.forward(z)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, x: torch.Tensor):
        """Data -> latents per level (level 0 first), and the log-det."""
        log_det = x.new_zeros(x.shape[0])
        if self.transform is not None:
            x, ld = self.transform.inverse(x)
            log_det = log_det + ld
        z_list = []
        z = x
        for i in range(len(self.flows) - 1, -1, -1):
            for layer in reversed(self.flows[i]):
                z, ld = layer.inverse(z)
                log_det = log_det + ld
            if i > 0:
                (z, z_level), ld = self.merges[i - 1].inverse({}, z)
                log_det = log_det + ld
                z_list.append(z_level)
        z_list.append(z)
        return list(reversed(z_list)), log_det

    def log_prob(self, x: torch.Tensor, y=None) -> torch.Tensor:
        z_list, log_q = self.inverse_and_log_det(x)
        for base, z in zip(self.bases, z_list):
            log_q = log_q + (base.log_prob(z) if y is None
                             else base.log_prob(z, y))
        return log_q

    def forward_kld(self, x: torch.Tensor, y=None) -> torch.Tensor:
        return -torch.mean(self.log_prob(x, y))

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None,
               y=None) -> torch.Tensor:
        """Each level's latent from its base in turn, pushed forward."""
        if y is None:
            z_list = [base.sample(num_samples, generator, self.device)
                      for base in self.bases]
        else:
            z_list = [base.sample(num_samples, y, generator)
                      for base in self.bases]
        return self.forward_and_log_det([z.to(self.dtype)
                                         for z in z_list])[0]
