"""The normalizing flow: a uniform torus base and a stack of couplings.

Port of ``flowstate_tpu/flows/core.py``: ``NormalizingFlow`` (:33),
``ScannedLayers`` (:249), ``build_circular_flow`` (:166),
``build_conditional_circular_flow`` (:203) and ``generate_samples``
(:333).  ``ScannedLayers`` passes one context, when it is given one, to
every layer step (the conditional flow, ``flows/models.py``).  A flow
built with an energy ``target`` (``flows/targets.py``) has
``reverse_kld``, the first loss that differentiates the forward
(sampling) direction.

The flow is an ``nn.Module`` that owns its parameters; ``ScannedLayers``
keeps the K layers' parameter trees stacked on a leading K axis, as the
JAX ``lax.scan`` over stacked params does, and loops over them (inverse
K-1 ... 0).  With ``scan_layers=False`` the builders give K
``ParamLayer``s instead, each with its own tree, as JAX's unrolled flow
has a tuple of K trees; the same numbers, without the paired pass (the
independence move then takes the separate passes, as JAX's
``_supports_paired`` decides).  JAX's ``remat`` has no counterpart:
training keeps plain autograd (the peak memory of a step is measured by
``chip_smoke.py`` phases 12 and 17).

Directions: ``forward`` is latent -> data (sampling), ``inverse`` data ->
latent (log_prob).
"""

from __future__ import annotations

import itertools
import pickle
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from flowstate_tpu_torch.flows.coupling import CircularSplineCoupling
from flowstate_tpu_torch.flows.distributions import UniformParticle
from flowstate_tpu_torch.flows.nets import Tree
from flowstate_tpu_torch.utils.profiling import annotate


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (JAX's
    ``tree_map`` on the parameter trees); a ``None`` is an empty subtree,
    as in JAX (``MaskedAffineFlow``'s missing scale net)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def placement(module: nn.Module):
    """``(device, dtype)`` of ``module``: the first parameter's or buffer's
    device and the first floating one's dtype, else the module's
    ``_placement`` (given when it was built)."""
    device, dtype = module._placement

    def tensors():
        return itertools.chain(module.parameters(), module.buffers())

    first = next(tensors(), None)
    floating = next((t for t in tensors() if t.is_floating_point()), None)
    return (device if first is None else first.device,
            dtype if floating is None else floating.dtype)


class ParamTree(nn.Module):
    """A parameter tree of nested dicts and lists held as ``nn.Parameter``
    leaves, named by their path (``net.blocks.0.l1.w``).  The root may be
    a dict or a list (``Composite``'s tuple of trees, MADE's list of
    linears, HAIS's list of layers); ``None`` leaves stay ``None``."""

    def __init__(self, tree: Tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        self._keys = []
        self._none = set()
        for k, v in items:
            k = str(k)
            self._keys.append(k)
            if v is None:
                self._none.add(k)
            elif isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, ParamTree(v))

    def tree(self) -> Tree:
        out = [] if self._is_list else {}
        for k in self._keys:
            v = None if k in self._none else getattr(self, k)
            if isinstance(v, ParamTree):
                v = v.tree()
            if self._is_list:
                out.append(v)
            else:
                out[k] = v
        return out


class ParamLayer(nn.Module):
    """One layer of a configuration with its own parameter tree, drawn
    from ``generator``.  The configuration is any object with
    ``init_params(generator, dtype=, device=)`` and ``forward`` /
    ``inverse(params, z, ...)``: a coupling, a layer of the flow zoo, or a
    base whose tree is trained (``DiagGaussian``; its ``sample`` and
    ``log_prob`` then take ``params.tree()``)."""

    def __init__(self, layer, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.layer = layer
        self.params = ParamTree(layer.init_params(generator, dtype=dtype,
                                                  device=device))

    def forward(self, z, *args, **kwargs):
        return self.layer.forward(self.params.tree(), z, *args, **kwargs)

    def inverse(self, x, *args, **kwargs):
        return self.layer.inverse(self.params.tree(), x, *args, **kwargs)


class ScannedLayers(nn.Module):
    """K layers of one configuration, parameters stacked on a leading K
    axis.  Each layer's init draws from ``generator`` in turn."""

    def __init__(self, layer: CircularSplineCoupling, K: int,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.layer = layer
        self.K = K
        trees = [layer.init_params(generator, dtype=dtype, device=device)
                 for _ in range(K)]
        self.params = ParamTree(tree_map(lambda *xs: torch.stack(xs), *trees))
        # step t of the paired pass: layer t forward, layer K-1-t inverse
        pairs = torch.stack([torch.arange(K), torch.arange(K - 1, -1, -1)], 1)
        self.register_buffer("_pairs", pairs.to(device), persistent=False)

    def _run(self, z: torch.Tensor, direction: str, order, context=None):
        stacked = self.params.tree()
        step = getattr(self.layer, direction)
        log_det = torch.zeros_like(z[:, 0])
        for k in order:
            z, d = step(tree_map(lambda a: a[k], stacked), z, context)
            log_det = log_det + d
        return z, log_det

    def forward(self, z: torch.Tensor, context=None):
        return self._run(z, "forward", range(self.K), context)

    def inverse(self, x: torch.Tensor, context=None):
        return self._run(x, "inverse", range(self.K - 1, -1, -1), context)

    def paired_forward_inverse(self, z_f: torch.Tensor, x_i: torch.Tensor,
                               context=None):
        """The forward chain on ``z_f`` and the inverse chain on ``x_i`` in
        one K-step loop: step t runs layer t forward and layer K-1-t
        inverse, their nets as one batched product (both given
        ``context``)."""
        # (K, 2, ...) leaves, gathered once per call
        paired = tree_map(lambda a: a[self._pairs], self.params.tree())
        ld_f = torch.zeros_like(z_f[:, 0])
        ld_i = torch.zeros_like(x_i[:, 0])
        for t in range(self.K):
            (z_f, df), (x_i, di) = self.layer.paired_forward_inverse(
                tree_map(lambda a: a[t], paired), z_f, x_i, context)
            ld_f = ld_f + df
            ld_i = ld_i + di
        return (z_f, ld_f), (x_i, ld_i)


class NormalizingFlow(nn.Module):
    """A chain of layers over a base distribution.

    Each layer's ``forward`` / ``inverse`` return ``(z, log_det)``.
    Sampling takes an explicit ``torch.Generator`` on the flow's device.
    ``target`` (optional) exposes ``energy(x)`` for ``reverse_kld``.  The
    base is any of ``flows.distributions``; its ``log_prob`` is taken
    without parameters, as JAX's flow does, so a trainable base (such as
    ``DiagGaussian``) stays at its init and adds nothing to
    ``parameters()``.  ``device`` and ``dtype`` are those of the first
    parameter or buffer; a flow without either (``Permute``,
    ``PeriodicWrap`` over ``UniformBase``) takes the ones given here.
    """

    def __init__(self, base, layers: Sequence[nn.Module], target=None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.base = base
        self.layers = nn.ModuleList(layers)
        self.target = target
        self._placement = (torch.device(device), dtype)

    @property
    def device(self) -> torch.device:
        return placement(self)[0]

    @property
    def dtype(self) -> torch.dtype:
        return placement(self)[1]

    # ----- transforms ---------------------------------------------------

    def forward_and_log_det(self, z: torch.Tensor):
        log_det = torch.zeros_like(z[:, 0])
        for layer in self.layers:
            z, ld = layer.forward(z)
            log_det = log_det + ld
        return z, log_det

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.forward_and_log_det(z)[0]

    def inverse_and_log_det(self, x: torch.Tensor):
        log_det = torch.zeros_like(x[:, 0])
        for layer in reversed(self.layers):
            x, ld = layer.inverse(x)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        return self.inverse_and_log_det(x)[0]

    # ----- losses -------------------------------------------------------

    def forward_kld(self, x: torch.Tensor,
                    include_base: bool = False) -> torch.Tensor:
        """Maximum-likelihood loss ``-mean(log q(x))``, less the constant
        base term unless ``include_base``."""
        z, log_q = self.inverse_and_log_det(x)
        if include_base:
            log_q = log_q + self.base.log_prob(z)
        return -torch.mean(log_q)

    def reverse_kld(self, num_samples: int,
                    generator: Optional[torch.Generator] = None):
        """Energy-based reverse KLD, the JAX form: z from the base, pushed
        forward with log q = -sum log_det (no base term); returns
        ``(mean(target.energy(x)) + mean(log q), x)``."""
        if self.target is None:
            raise ValueError("reverse_kld requires a target with .energy()")
        x, log_det = self.forward_and_log_det(
            self._base_sample(num_samples, generator))
        return torch.mean(self.target.energy(x)) + torch.mean(-log_det), x

    # ----- sampling and density -----------------------------------------

    def _base_sample(self, num_samples: int,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.base.sample(num_samples, generator,
                                self.device).to(self.dtype)

    def sample(self, num_samples: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.forward(self._base_sample(num_samples, generator))

    def sample_and_log_prob(self, num_samples: int,
                            generator: Optional[torch.Generator] = None):
        """Samples and their log q in one forward pass (a span
        ``flow.sample_and_log_prob``)."""
        with annotate("flow.sample_and_log_prob"):
            z = self._base_sample(num_samples, generator)
            x, log_det = self.forward_and_log_det(z)
            return x, self.base.log_prob(z) - log_det

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log q of ``x`` by one inverse pass (a span ``flow.log_prob``)."""
        with annotate("flow.log_prob"):
            z, log_q = self.inverse_and_log_det(x)
            return log_q + self.base.log_prob(z)

    def sample_and_log_prob_with_old(self, num_samples: int,
                                     x_old: torch.Tensor,
                                     generator: Optional[torch.Generator]
                                     = None):
        """``(x_new, log_q_new, log_q_old)``: the independence move's flow
        work.  On a single ``ScannedLayers`` the two sweeps run in one
        paired loop; otherwise as separate passes."""
        z = self._base_sample(num_samples, generator)
        lq0 = self.base.log_prob(z)
        if len(self.layers) == 1 and isinstance(self.layers[0],
                                                ScannedLayers):
            (x_new, ld_f), (z_old, ld_i) = (
                self.layers[0].paired_forward_inverse(z, x_old))
            return x_new, lq0 - ld_f, ld_i + self.base.log_prob(z_old)
        x_new, ld_f = self.forward_and_log_det(z)
        return x_new, lq0 - ld_f, self.log_prob(x_old)

    # ----- persistence --------------------------------------------------

    def save(self, path: str) -> None:
        """A pickle of the JAX package's parameter layout (numpy arrays),
        which ``flows.convert.params_from_jax`` and the JAX
        ``NormalizingFlow.load`` both read."""
        from flowstate_tpu_torch.flows.convert import params_to_jax

        with open(path, "wb") as f:
            pickle.dump(params_to_jax(self), f)

    def load(self, path: str) -> "NormalizingFlow":
        """Load a file ``save`` (of either package) wrote; only files this
        program or its users wrote, since unpickling runs code."""
        from flowstate_tpu_torch.flows.convert import params_from_jax

        with open(path, "rb") as f:
            return params_from_jax(pickle.load(f), self)


def _layers(layer: CircularSplineCoupling, K: int, scan_layers: bool,
            generator: Optional[torch.Generator], dtype, device) -> list:
    """One ``ScannedLayers`` of K, or K ``ParamLayer``s; either way the K
    trees are drawn from ``generator`` in turn, so the two hold the same
    numbers."""
    layer = layer.to(device)
    if scan_layers:
        return [ScannedLayers(layer, K, generator, dtype=dtype,
                              device=device)]
    return [ParamLayer(layer, generator, dtype=dtype, device=device)
            for _ in range(K)]


def build_circular_flow(num_particles: int, num_dim: int, half_box: float,
                        K: int = 15, hidden_units: int = 256,
                        num_bins: int = 32, num_blocks: int = 2,
                        net_type: str = "residual", target=None,
                        generator: Optional[torch.Generator] = None,
                        dtype=torch.float32, device="cuda",
                        scan_layers: bool = True,
                        compute_dtype: Optional[str] = None
                        ) -> NormalizingFlow:
    """The hybrid experiments' flow: a uniform torus base and K circular
    couplings with the ``net_type`` conditioner, in one ``ScannedLayers``
    (or K ``ParamLayer``s without ``scan_layers``), on ``device``, with an
    optional energy ``target``; ``compute_dtype`` the residual net's."""
    dim = num_particles * num_dim
    layer = CircularSplineCoupling(
        features=dim, num_blocks=num_blocks, hidden_units=hidden_units,
        ind_circ=tuple(range(dim)), num_bins=num_bins, tail_bound=half_box,
        net_type=net_type, compute_dtype=compute_dtype)
    return NormalizingFlow(UniformParticle(num_particles, num_dim, half_box),
                           _layers(layer, K, scan_layers, generator, dtype,
                                   device), target)


def build_conditional_circular_flow(block_particles: int, num_dim: int,
                                    half_box: float, context_features: int,
                                    K: int = 10, hidden_units: int = 256,
                                    num_bins: int = 16, num_blocks: int = 2,
                                    generator: Optional[torch.Generator]
                                    = None, dtype=torch.float32,
                                    device="cuda", scan_layers: bool = True):
    """The blocked move's proposal (``mcmc/blocked.py``): a uniform torus
    base over a block of ``block_particles`` particles and K circular
    couplings, each conditioner gated by a ``context_features``-wide
    context, in one ``ScannedLayers`` (or K ``ParamLayer``s without
    ``scan_layers``); a ``ConditionalNormalizingFlow`` on ``device``."""
    from flowstate_tpu_torch.flows.models import ConditionalNormalizingFlow

    dim = block_particles * num_dim
    layer = CircularSplineCoupling(
        features=dim, num_blocks=num_blocks, hidden_units=hidden_units,
        ind_circ=tuple(range(dim)), num_bins=num_bins, tail_bound=half_box,
        context_features=context_features)
    return ConditionalNormalizingFlow(
        UniformParticle(block_particles, num_dim, half_box),
        _layers(layer, K, scan_layers, generator, dtype, device))


def generate_samples(model: NormalizingFlow, generator: torch.Generator,
                     n_iterations: int, samples_per_iteration: int = 5000,
                     num_particles: Optional[int] = None,
                     num_dim: Optional[int] = None) -> np.ndarray:
    """Samples in chunks of ``samples_per_iteration``, as a host array:
    (M, N, d) when the particle shape is given, else (M, dim)."""
    with torch.no_grad():
        chunks = [model.sample(samples_per_iteration, generator).cpu().numpy()
                  for _ in range(n_iterations)]
    out = np.concatenate(chunks, axis=0)
    if num_particles is not None and num_dim is not None:
        out = out.reshape(-1, num_particles, num_dim)
    return out

