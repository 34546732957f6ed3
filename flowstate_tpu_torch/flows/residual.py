"""Invertible residual flows (i-ResNet) with Lipschitz-constrained nets.

Port of ``flowstate_tpu/flows/residual.py``:

* the activations ``lipswish``, ``leaky_elu``, ``asym_squash`` and the
  roulette helpers (:47-104): ``geometric_sample`` / ``poisson_sample``
  draw from a ``torch.Generator``, ``geometric_1mcdf`` / ``poisson_1mcdf``
  are plain Python floats, ``batch_jacobian`` is ``torch.func.jacfwd``
  under ``vmap``;
* ``LipschitzMLP`` (:106): linears ``x @ w`` with ``w`` (in, out), each
  scaled by ``min(1, coeff / sigma)``, sigma one power-iteration step from
  the stored vector ``u``.  ``u`` is a leaf of the tree and its gradient
  is not stopped, so an optimizer moves it, as JAX's does;
  ``update_lipschitz`` refreshes it;
* ``Residual`` (:157): x + g(x) with the ``exact``, ``series`` and
  ``unbiased`` log-det estimators and the fixed-point inverse;
* ``LipschitzCNN`` (:297): the conv net, its transpose a conv with the
  kernel flipped and transposed.

The power-series estimators take ``torch.autograd.grad`` of g at x once
per term, with ``create_graph`` when grad is enabled, so a loss
differentiates through them as ``jax.grad`` does through ``jax.vjp``; the
fixed-point inverse keeps its graph as JAX's ``fori_loop`` does.  Their
noise is a pair ``(eps, n)``, the Rademacher probes and the roulette draw
(``Residual.draw``), given as tensors or drawn from a generator.  They sum
``v * e`` over every axis but the batch: on (B, D) that is JAX's
``axis=-1``, and on images it gives the per-sample log-det where JAX's
sum over the last axis fails to broadcast (ROADMAP R16).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flowstate_tpu_torch.flows.nets import _linear_init, conv2d


def lipswish(x: torch.Tensor) -> torch.Tensor:
    """LipSwish: swish / 1.1 (Lipschitz constant 1)."""
    return F.silu(x) / 1.1


def leaky_elu(x: torch.Tensor, a: float = 0.3) -> torch.Tensor:
    return a * x + (1 - a) * F.elu(x)


def asym_squash(x: torch.Tensor) -> torch.Tensor:
    """An increasing map of the real line onto (1, 5)."""
    return torch.tanh(-leaky_elu(-x + 0.5493061829986572)) * 2.0 + 3.0


def geometric_from_uniform(u: torch.Tensor, p: float) -> torch.Tensor:
    """N ~ Geometric(p) on {1, 2, ...} from uniforms ``u`` in (0, 1)."""
    return torch.floor(torch.log(u) / math.log1p(-p)).to(torch.int32) + 1


def geometric_sample(generator: Optional[torch.Generator], p: float,
                     shape=(), device="cuda") -> torch.Tensor:
    """N ~ Geometric(p) on {1, 2, ...}, float32 uniforms from
    ``generator`` kept above float32's ``tiny`` as JAX's ``minval``."""
    u = torch.rand(shape, generator=generator, device=device)
    return geometric_from_uniform(
        torch.clamp_min(u, torch.finfo(torch.float32).tiny), p)


def poisson_sample(generator: Optional[torch.Generator], lamb: float,
                   shape=(), device="cuda") -> torch.Tensor:
    rate = torch.full(shape, float(lamb), device=device)
    return torch.poisson(rate, generator=generator).to(torch.int32)


def geometric_1mcdf(p: float, k: int, offset: int) -> float:
    """P(N >= k - offset) for N ~ Geometric(p)."""
    if k <= offset:
        return 1.0
    return float((1.0 - p) ** max(k - offset - 1, 0))


def poisson_1mcdf(lamb: float, k: int, offset: int) -> float:
    """P(N >= k - offset) for N ~ Poisson(lamb)."""
    if k <= offset:
        return 1.0
    total = sum(lamb ** i / math.factorial(i) for i in range(k - offset))
    return float(1.0 - np.exp(-lamb) * total)


def batch_jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """(B, D, D) Jacobian of a batched map ``f`` at the rows of ``x``."""
    return torch.func.vmap(torch.func.jacfwd(lambda v: f(v[None])[0]))(x)


def batch_trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v), 1e-12)


def _sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(1, x.dim())))


@dataclasses.dataclass(frozen=True)
class LipschitzMLP:
    """MLP of spectrally normalised linears (Lipschitz below ``coeff``)
    with LipSwish between them; a layer is ``{"w", "b", "u"}``."""

    channels: Tuple[int, ...]   # (in, hidden..., out)
    coeff: float = 0.97
    n_power_iter: int = 1

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        layers = []
        for i in range(len(self.channels) - 1):
            lin = _linear_init(self.channels[i], self.channels[i + 1],
                               generator, dtype, device)
            u = torch.randn(self.channels[i + 1], generator=generator,
                            dtype=dtype, device=device)
            layers.append({**lin, "u": u / torch.linalg.norm(u)})
        return layers

    def _normalized_w(self, layer) -> torch.Tensor:
        """``w`` scaled by ``min(1, coeff / sigma)``, sigma one power step
        from the stored ``u``."""
        w = layer["w"]
        v = _normalize(w @ layer["u"])
        sigma = torch.clamp_min(torch.linalg.norm(v @ w), 1e-12)
        return w * torch.clamp_max(self.coeff / sigma, 1.0)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(params):
            x = x @ self._normalized_w(layer) + layer["b"]
            if i < len(params) - 1:
                x = lipswish(x)
        return x

    @torch.no_grad()
    def update_lipschitz(self, params, n_iterations: int = 5):
        """The tree with each ``u`` moved ``n_iterations`` power-iteration
        steps (normflows' ``utils/optim.py::update_lipschitz``)."""
        new = []
        for layer in params:
            w, u = layer["w"], layer["u"]
            for _ in range(n_iterations):
                u = _normalize(_normalize(w @ u) @ w)
            new.append({**layer, "u": u})
        return new


@dataclasses.dataclass(frozen=True)
class Residual:
    """The invertible residual block x + g(x).  ``reverse=True`` (the
    reference's default): ``forward`` is the fixed-point inverse of
    x + g(x) and ``inverse`` applies x + g(x).

    ``forward`` / ``inverse(params, z, generator=None, noise=None)``:
    ``noise`` is ``draw``'s ``(eps, n)``; without it ``unbiased`` draws
    from ``generator`` (and refuses to run without one) and ``series``
    draws from ``generator`` or, without one, from a generator seeded 0,
    the same probes at every call as JAX's ``key(0)``."""

    net: LipschitzMLP
    reverse: bool = True
    estimator: str = "exact"      # 'exact' | 'series' | 'unbiased'
    n_power_series: int = 8       # truncation ('series') / static cap ('unbiased')
    n_trace_samples: int = 1
    fixed_point_iters: int = 50
    dim: int = 0                  # required for 'exact'
    n_dist: str = "geometric"     # roulette distribution ('unbiased')
    geom_p: float = 0.5
    lamb: float = 2.0
    n_exact_terms: int = 2        # always-kept leading terms ('unbiased')

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"net": self.net.init_params(generator, dtype=dtype,
                                            device=device)}

    def _g(self, params, x):
        return self.net.apply(params["net"], x)

    # -- noise -------------------------------------------------------------

    def draw(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """``(eps, n)``: the Rademacher probes (n_trace_samples, *x.shape)
        in ``x``'s dtype and, for ``unbiased``, the roulette draw N (a 0-d
        int32 tensor; None otherwise), N drawn first."""
        n = None
        if self.estimator == "unbiased":
            if self.n_dist == "geometric":
                n = geometric_sample(generator, self.geom_p, (), x.device)
            elif self.n_dist == "poisson":
                n = poisson_sample(generator, self.lamb, (), x.device)
            else:
                raise ValueError(f"unknown n_dist {self.n_dist!r}")
        bits = torch.randint(0, 2, (self.n_trace_samples, *x.shape),
                             generator=generator, device=x.device)
        return bits.to(x.dtype) * 2 - 1, n

    # -- log-det estimators ------------------------------------------------

    def _logdet_exact(self, params, x):
        jac = batch_jacobian(lambda v: self._g(params, v), x)
        eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
        return torch.linalg.slogdet(eye + jac)[1]

    def _series_coeffs(self, n, dtype):
        """The weight of term k = 1 ... n_power_series: (-1)^(k+1) / k,
        for ``unbiased`` times 1{k - n_exact <= N} / P(N >= k - n_exact)
        (a tensor in ``dtype``)."""
        ks = range(1, self.n_power_series + 1)
        plain = [(-1.0) ** (k + 1) / k for k in ks]
        if n is None:
            return plain
        if self.n_dist == "geometric":
            rcdf = [geometric_1mcdf(self.geom_p, k, self.n_exact_terms)
                    for k in ks]
        elif self.n_dist == "poisson":
            rcdf = [poisson_1mcdf(self.lamb, k, self.n_exact_terms)
                    for k in ks]
        else:
            raise ValueError(f"unknown n_dist {self.n_dist!r}")
        return [c * (k - self.n_exact_terms <= n).to(dtype) / r
                for k, c, r in zip(ks, plain, rcdf)]

    def _logdet_series(self, params, x, eps, coeffs):
        """Hutchinson's estimate of sum_k c_k tr(J^k): v_k = v_{k-1} J
        by one vector-Jacobian product a term, mean over the probes."""
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_()
            gx = self._g(params, xg)
            lds = []
            for e in eps:
                v, ld = e, x.new_zeros(x.shape[0])
                for c in coeffs:
                    (v,) = torch.autograd.grad(gx, xg, v, retain_graph=True,
                                               create_graph=create)
                    ld = ld + c * _sum_except_batch(v * e)
                lds.append(ld)
        return torch.stack(lds).mean(dim=0)

    def _logdetgrad(self, params, x, generator=None, noise=None):
        if self.estimator == "exact":
            return self._logdet_exact(params, x)
        if self.estimator == "unbiased":
            if noise is None and generator is None:
                raise ValueError(
                    "estimator='unbiased' needs fresh noise per call (pass "
                    "generator= or noise= to forward/inverse); with fixed "
                    "noise the roulette draw repeats and the estimator is "
                    "biased")
        elif self.estimator != "series":
            raise ValueError(f"unknown estimator {self.estimator!r}")
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            noise = self.draw(x, generator)
        eps, n = noise
        return self._logdet_series(params, x, eps,
                                   self._series_coeffs(n, x.dtype))

    # -- the residual map --------------------------------------------------

    def _apply_map(self, params, x, generator=None, noise=None):
        return (x + self._g(params, x),
                self._logdetgrad(params, x, generator, noise))

    def _inverse_fixed_point(self, params, y):
        """Banach iteration x <- y - g(x), ``fixed_point_iters`` times
        after x0 = y - g(y); differentiable throughout."""
        x = y - self._g(params, y)
        for _ in range(self.fixed_point_iters):
            x = y - self._g(params, x)
        return x

    def _fixed_point_and_log_det(self, params, y, generator, noise):
        x = self._inverse_fixed_point(params, y)
        return x, -self._logdetgrad(params, x, generator, noise)

    def forward(self, params, z, generator=None, noise=None):
        if self.reverse:
            return self._fixed_point_and_log_det(params, z, generator, noise)
        return self._apply_map(params, z, generator, noise)

    def inverse(self, params, z, generator=None, noise=None):
        if self.reverse:
            return self._apply_map(params, z, generator, noise)
        return self._fixed_point_and_log_det(params, z, generator, noise)


@dataclasses.dataclass(frozen=True)
class LipschitzCNN:
    """CNN of spectrally normalised convs with LipSwish between them,
    NCHW.  A layer is ``{"w", "b", "u"}``, ``u`` an output-shaped image
    (1, out, H, W) on which the conv's operator norm is estimated."""

    channels: Tuple[int, ...]          # (in, hidden..., out)
    kernel_size: Tuple[int, ...]       # per layer, odd
    spatial: Tuple[int, int]           # (H, W) the operator norm is taken on
    coeff: float = 0.97

    def _conv(self, w, x):
        return conv2d(x, w, padding=w.shape[-1] // 2)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        layers = []
        h, w_sp = self.spatial
        for i in range(len(self.channels) - 1):
            kk = self.kernel_size[i]
            bound = 1.0 / np.sqrt(self.channels[i] * kk * kk)
            shape = (self.channels[i + 1], self.channels[i], kk, kk)
            w = (torch.rand(shape, generator=generator, dtype=dtype,
                            device=device) * (2 * bound) - bound)
            u = torch.randn((1, self.channels[i + 1], h, w_sp),
                            generator=generator, dtype=dtype, device=device)
            layers.append({"w": w,
                           "b": torch.zeros(self.channels[i + 1],
                                            dtype=dtype, device=device),
                           "u": u / torch.linalg.norm(u)})
        return layers

    @staticmethod
    def _transpose(w):
        """The transpose's kernel: in and out swapped, flipped in space."""
        return torch.flip(w.transpose(0, 1), dims=(-1, -2))

    def _sigma(self, layer):
        """One power-iteration step's estimate of the conv's norm."""
        w = layer["w"]
        v = _normalize(self._conv(self._transpose(w), layer["u"]))
        return torch.clamp_min(torch.linalg.norm(self._conv(w, v)), 1e-12)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(params):
            factor = torch.clamp_max(self.coeff / self._sigma(layer), 1.0)
            x = (self._conv(layer["w"] * factor, x)
                 + layer["b"][None, :, None, None])
            if i < len(params) - 1:
                x = lipswish(x)
        return x

    @torch.no_grad()
    def update_lipschitz(self, params, n_iterations: int = 5):
        new = []
        for layer in params:
            w, u = layer["w"], layer["u"]
            w_t = self._transpose(w)
            for _ in range(n_iterations):
                u = _normalize(self._conv(w, _normalize(self._conv(w_t, u))))
            new.append({**layer, "u": u})
        return new
