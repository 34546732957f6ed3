"""Induced p-norm Lipschitz layers for residual flows.

Port of ``flowstate_tpu/flows/lipschitz.py``: linear and conv layers
soft-normalised by their induced (domain -> codomain) operator norm,
estimated by the nonlinear power iteration (``normalize_u`` /
``normalize_v`` for p = 1, 2, any finite p > 1 and inf), optionally with
learnable orders squashed into (1, 5) by ``asym_squash``; the soft scale
``W / max(1, sigma / coeff)``; best-of-10 restarts of the iteration
vectors at init off the Euclidean case; ``compute_one_iter``, whose
gradient reaches the learnable orders only.

``u`` and ``v`` are leaves of the tree, refreshed by ``update_lipschitz``
(under ``no_grad``); ``compute_weight`` and ``compute_one_iter`` detach
them, as JAX's ``stop_gradient`` does, so they take a zero gradient.  The conv's adjoint is the gradient of the
same convolution (``torch.autograd.grad``), exact for any stride and
padding; ``spatial_dims`` is fixed at construction.  The best-of-restarts
comparison reads each restart's sigma on the host, at init only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from flowstate_tpu_torch.flows.nets import conv2d
from flowstate_tpu_torch.flows.residual import asym_squash

Ord = Union[float, int]


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient at 0 (1; ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def vector_norm(x: torch.Tensor, p) -> torch.Tensor:
    """||x||_p for p >= 1; ``p`` may be a tensor."""
    x = _abs(x.reshape(-1))
    return torch.sum(x ** p) ** (1.0 / p)


def projmax(v: torch.Tensor) -> torch.Tensor:
    """The signed one-hot at the first argmax of |v| (the p = 1 / q = inf
    limit of the dual normalisation); the dominant component's sign is
    kept."""
    i = torch.argmax(torch.abs(v))
    sign = torch.where(v[i] < 0, -1.0, 1.0).to(v.dtype)
    return F.one_hot(i, v.shape[0]).to(v.dtype) * sign


def _phase(x: torch.Tensor) -> torch.Tensor:
    a = torch.abs(x)
    zero = a == 0
    return torch.where(zero, 1.0, x / torch.where(zero, 1.0, a))


def _is_number(order) -> bool:
    return isinstance(order, (int, float))


def normalize_v(v: torch.Tensor, domain) -> torch.Tensor:
    """The input-side iteration vector, normalised for the domain p-norm."""
    if _is_number(domain):
        if domain == 2:
            return v / torch.clamp_min(torch.linalg.norm(v), 1e-12)
        if domain == 1:
            return projmax(v)
    vabs = _abs(v)
    vabs = vabs / torch.clamp_min(torch.max(vabs), 1e-12)
    vabs = vabs ** (1.0 / (domain - 1.0))
    return _phase(v) * vabs / torch.clamp_min(vector_norm(vabs, domain),
                                              1e-12)


def normalize_u(u: torch.Tensor, codomain) -> torch.Tensor:
    """The output-side iteration vector, normalised for the codomain
    q-norm."""
    if _is_number(codomain):
        if codomain == 2:
            return u / torch.clamp_min(torch.linalg.norm(u), 1e-12)
        if codomain == math.inf:
            return projmax(u)
        if codomain == 1:
            uabs = _abs(u) ** 0.0   # (q - 1) = 0: all mass equal
            return _phase(u) * uabs / torch.clamp_min(torch.max(uabs), 1e-12)
    uabs = _abs(u)
    uabs = uabs / torch.clamp_min(torch.max(uabs), 1e-12)
    uabs = uabs ** (codomain - 1.0)
    dual = codomain / (codomain - 1.0)
    return _phase(u) * uabs / torch.clamp_min(vector_norm(uabs, dual), 1e-12)


def _kaiming_uniform(generator, out_f: int, in_f: int, *ksize,
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Torch's default ``kaiming_uniform_(a=sqrt(5))`` of a Linear or Conv
    weight: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in = in_f * math.prod(ksize)
    bound = math.sqrt(6.0 / ((1 + 5) * fan_in))
    u = torch.rand((out_f, in_f, *ksize), generator=generator, dtype=dtype,
                   device=device)
    return u * (2 * bound) - bound


def _uniform(generator, n: int, bound: float, dtype, device):
    return (torch.rand(n, generator=generator, dtype=dtype, device=device)
            * (2 * bound) - bound)


class _InducedNorm:
    """What the linear and the conv layer share: the orders, the init's
    restarts and the soft normalisation.  A subclass gives ``_weight``,
    ``_sizes``, ``_power_iter`` and ``_wv`` (the weight applied to
    ``v``)."""

    def _orders(self, params):
        if self.learnable_ord:
            return (asym_squash(params["domain_raw"]),
                    asym_squash(params["codomain_raw"]))
        return self.domain, self.codomain

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        w, fan_in = self._weight(generator, dtype, device)
        if self.zero_init:
            w = w / 1000.0
        params = {"w": w}
        if self.bias:
            params["b"] = _uniform(generator, w.shape[0],
                                   1.0 / math.sqrt(fan_in), dtype, device)
        if self.learnable_ord:
            params["domain_raw"] = torch.tensor(float(self.domain),
                                                dtype=dtype, device=device)
            params["codomain_raw"] = torch.tensor(float(self.codomain),
                                                  dtype=dtype, device=device)
        domain, codomain = self._orders(params)
        n_out, n_in = self._sizes(w)

        def run():
            u0 = normalize_u(torch.randn(n_out, generator=generator,
                                         dtype=dtype, device=device),
                             codomain)
            v0 = normalize_v(torch.randn(n_in, generator=generator,
                                         dtype=dtype, device=device), domain)
            return self._power_iter(w, u0, v0, domain, codomain, 200)

        with torch.no_grad():
            u, v, scale = run()
            euclidean = (not self.learnable_ord
                         and self.domain == 2 and self.codomain == 2)
            if not euclidean:
                for _ in range(10):
                    u_i, v_i, s_i = run()
                    if float(s_i) > float(scale):
                        u, v, scale = u_i, v_i, s_i
        params["u"], params["v"] = u, v
        return params

    def compute_weight(self, params) -> torch.Tensor:
        """``W / max(1, sigma / coeff)``, sigma = u . W v with ``u`` and
        ``v`` detached: its gradient flows through W only."""
        w = params["w"]
        sigma = torch.dot(params["u"].detach(), self._wv(w, params["v"]
                                                         .detach()))
        return w / torch.clamp_min(sigma / self.coeff, 1.0)

    @torch.no_grad()
    def update_lipschitz(self, params, n_iterations: Optional[int] = None):
        """The tree with ``u`` and ``v`` moved by power iteration."""
        domain, codomain = self._orders(params)
        u, v, _ = self._power_iter(params["w"], params["u"], params["v"],
                                   domain, codomain,
                                   n_iterations or self.n_iterations)
        return {**params, "u": u, "v": v}

    def compute_one_iter(self, params) -> torch.Tensor:
        """One iteration's sigma, differentiable in the learnable orders
        only (the weight, ``u`` and ``v`` detached)."""
        domain, codomain = self._orders(params)
        _, _, sigma = self._power_iter(
            params["w"].detach(), params["u"].detach(),
            params["v"].detach(), domain, codomain, 1)
        return sigma


@dataclasses.dataclass(frozen=True)
class InducedNormLinear(_InducedNorm):
    """A linear layer soft-normalised by its induced norm; ``w`` is
    (out, in), applied as ``x @ W.T``."""

    in_features: int
    out_features: int
    bias: bool = True
    coeff: float = 0.97
    domain: Ord = 2
    codomain: Ord = 2
    n_iterations: int = 5
    zero_init: bool = False
    learnable_ord: bool = False

    def _weight(self, generator, dtype, device):
        return (_kaiming_uniform(generator, self.out_features,
                                 self.in_features, dtype=dtype,
                                 device=device), self.in_features)

    def _sizes(self, w):
        return self.out_features, self.in_features

    def _wv(self, w, v):
        return w @ v

    def _power_iter(self, w, u, v, domain, codomain, n):
        for _ in range(n):
            u = normalize_u(w @ v, codomain)
            v = normalize_v(w.T @ u, domain)
        return u, v, torch.dot(u, w @ v)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.compute_weight(params).T
        if self.bias:
            y = y + params["b"]
        return y


@dataclasses.dataclass(frozen=True)
class InducedNormConv2d(_InducedNorm):
    """Conv2d soft-normalised by the induced norm of the whole conv
    operator on an (in_channels, H, W) field; the power iteration runs
    the convolution and its adjoint over that field."""

    in_channels: int
    out_channels: int
    kernel_size: int
    spatial_dims: Tuple[int, int]
    stride: int = 1
    padding: Optional[int] = None     # default: kernel_size // 2
    bias: bool = True
    coeff: float = 0.97
    domain: Ord = 2
    codomain: Ord = 2
    n_iterations: int = 5
    zero_init: bool = False
    learnable_ord: bool = False

    @property
    def _padding(self) -> int:
        return (self.kernel_size // 2 if self.padding is None
                else self.padding)

    def _conv(self, w, v_img):
        return conv2d(v_img, w, stride=self.stride, padding=self._padding)

    def _weight(self, generator, dtype, device):
        ks = self.kernel_size
        return (_kaiming_uniform(generator, self.out_channels,
                                 self.in_channels, ks, ks, dtype=dtype,
                                 device=device),
                self.in_channels * ks * ks)

    def _sizes(self, w):
        h, wid = self.spatial_dims
        k, s, p = self.kernel_size, self.stride, self._padding
        h_out, w_out = (h + 2 * p - k) // s + 1, (wid + 2 * p - k) // s + 1
        return (self.out_channels * h_out * w_out,
                self.in_channels * h * wid)

    def _wv(self, w, v):
        h, wid = self.spatial_dims
        return self._conv(w, v.reshape(1, self.in_channels, h, wid)
                          ).reshape(-1)

    def _adjoint(self, w, u):
        """W^T u: the gradient of u . W x in x (W is linear, so at x = 0),
        differentiable in ``u`` and ``w`` where grad is enabled."""
        create = torch.is_grad_enabled() and (u.requires_grad
                                              or w.requires_grad)
        with torch.enable_grad():
            x = torch.zeros(self.in_channels * math.prod(self.spatial_dims),
                            dtype=u.dtype, device=u.device,
                            requires_grad=True)
            (v,) = torch.autograd.grad(self._wv(w, x), x, u,
                                       create_graph=create)
        return v

    def _power_iter(self, w, u, v, domain, codomain, n):
        for _ in range(n):
            u = normalize_u(self._wv(w, v), codomain)
            v = normalize_v(self._adjoint(w, u), domain)
        return u, v, torch.dot(u, self._wv(w, v))

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, C_out, H', W')."""
        y = self._conv(self.compute_weight(params), x)
        if self.bias:
            y = y + params["b"][None, :, None, None]
        return y


def swish(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Swish with a learnable beta, over 1.1 (Lipschitz at most 1)."""
    return x * torch.sigmoid(x * F.softplus(beta)) / 1.1


class _InducedNormStack:
    """Swish then an induced-norm layer, per layer; the last layer's
    weight starts at a thousandth; a layer's tree is ``{"beta", ...}``
    with ``beta`` a 0-d leaf."""

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return [{"beta": torch.tensor(0.5, dtype=dtype, device=device),
                 **lay.init_params(generator, dtype=dtype, device=device)}
                for lay in self.layers]

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        for lay, p in zip(self.layers, params):
            x = lay.apply(p, swish(x, p["beta"]))
        return x

    def update_lipschitz(self, params, n_iterations: int = 5):
        return [lay.update_lipschitz(p, n_iterations)
                for lay, p in zip(self.layers, params)]

    def compute_one_iter(self, params):
        return torch.stack([lay.compute_one_iter(p)
                            for lay, p in zip(self.layers, params)])


@dataclasses.dataclass(frozen=True)
class InducedNormMLP(_InducedNormStack):
    """Swish + ``InducedNormLinear`` layers, a ``Residual`` net."""

    channels: Tuple[int, ...]
    coeff: float = 0.97
    domain: Ord = 2
    codomain: Ord = 2
    n_iterations: int = 5
    learnable_ord: bool = False

    @property
    def layers(self) -> Tuple[InducedNormLinear, ...]:
        n = len(self.channels) - 1
        return tuple(
            InducedNormLinear(
                self.channels[i], self.channels[i + 1], coeff=self.coeff,
                domain=self.domain, codomain=self.codomain,
                n_iterations=self.n_iterations,
                zero_init=(i == n - 1), learnable_ord=self.learnable_ord)
            for i in range(n))


@dataclasses.dataclass(frozen=True)
class InducedNormCNN(_InducedNormStack):
    """Swish + ``InducedNormConv2d`` layers; kernel i maps channels[i]
    to channels[i + 1]."""

    channels: Tuple[int, ...]
    kernel_size: Tuple[int, ...]
    spatial_dims: Tuple[int, int]
    coeff: float = 0.97
    domain: Ord = 2
    codomain: Ord = 2
    n_iterations: int = 5
    learnable_ord: bool = False

    @property
    def layers(self) -> Tuple[InducedNormConv2d, ...]:
        n = len(self.kernel_size)
        return tuple(
            InducedNormConv2d(
                self.channels[i], self.channels[i + 1], self.kernel_size[i],
                spatial_dims=self.spatial_dims, coeff=self.coeff,
                domain=self.domain, codomain=self.codomain,
                n_iterations=self.n_iterations,
                zero_init=(i == n - 1), learnable_ord=self.learnable_ord)
            for i in range(n))
