"""Autoregressive flows: MADE, and the affine and RQ-spline transforms it
parameterises.

Port of ``flowstate_tpu/flows/autoregressive.py``:

* ``MADE`` (:35): the masked MLP with sequential degrees, its masks built
  in numpy as JAX builds them (output unit ``i * M + k`` sees only the
  inputs before feature ``i``), and an optional cos/sin featurisation at
  ``periodic_scale`` that doubles the input (the degrees repeat);
* ``MaskedAffineAutoregressive`` (:97) and
  ``MaskedPiecewiseRQSAutoregressive`` (:138), with tails none, linear,
  circular or one per dimension (``ops/splines.py``);
* ``AutoregressiveRationalQuadraticSpline`` (:212) and
  ``CircularAutoregressiveRationalQuadraticSpline`` (:248), with the MAF
  convention: the flow's ``forward`` (sampling) is the inner transform's
  sequential inverse, its ``inverse`` (density) the one-pass direction.

The sequential inverse is JAX's ``fori_loop`` over the features (:121-133,
:185-192) as a Python loop: D passes, each running the whole MADE, then
one more for the log-det.  JAX's MADE takes its products with
``preferred_element_type=float32`` even under x64 (:89-90), so its float64
output carries float32 rounding (ROADMAP R14); the port keeps the input's
dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional

import numpy as np
import torch

from flowstate_tpu_torch.flows.nets import Tree, _linear_init
from flowstate_tpu_torch.ops.splines import (
    IDENTITY_DERIVATIVE_CONSTANT, rational_quadratic_spline,
    unconstrained_rational_quadratic_spline_sum,
)


@dataclasses.dataclass(frozen=True)
class MADE:
    """Masked autoencoder for distribution estimation: a plain masked MLP
    of ``num_blocks`` hidden layers with ``features * output_multiplier``
    outputs."""

    features: int
    hidden_features: int
    num_blocks: int = 2
    output_multiplier: int = 2
    periodic_scale: Optional[float] = None  # cos/sin featurisation scale

    def _degrees(self):
        in_deg = np.arange(1, self.features + 1)
        hid_deg = (np.arange(self.hidden_features)
                   % max(1, self.features - 1)) + 1
        out_deg = np.repeat(np.arange(1, self.features + 1),
                            self.output_multiplier)
        return in_deg, hid_deg, out_deg

    def _masks(self) -> List[np.ndarray]:
        in_deg, hid_deg, out_deg = self._degrees()
        if self.periodic_scale is not None:
            in_deg = np.tile(in_deg, 2)
        masks = [(hid_deg[None, :] >= in_deg[:, None]).astype(np.float32)]
        for _ in range(self.num_blocks - 1):
            masks.append(
                (hid_deg[None, :] >= hid_deg[:, None]).astype(np.float32))
        masks.append((out_deg[None, :] > hid_deg[:, None]).astype(np.float32))
        return masks

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda",
                    init_identity: bool = False,
                    identity_bias: float = 0.0) -> List[Tree]:
        """``nn.Linear``'s default init per layer; with ``init_identity``
        the output layer is w = 0, b = ``identity_bias``."""
        layers = [_linear_init(m.shape[0], m.shape[1], generator, dtype,
                               device) for m in self._masks()]
        if init_identity:
            last = layers[-1]
            layers[-1] = {"w": torch.zeros_like(last["w"]),
                          "b": torch.full_like(last["b"], identity_bias)}
        return layers

    def apply(self, params: List[Tree], x: torch.Tensor) -> torch.Tensor:
        if self.periodic_scale is not None:
            x = torch.cat([torch.cos(self.periodic_scale * x),
                           torch.sin(self.periodic_scale * x)], dim=-1)
        masks = _mask_tensors(self, params[0]["w"].dtype,
                              params[0]["w"].device)
        for i, (p, m) in enumerate(zip(params, masks)):
            x = torch.matmul(x, p["w"] * m) + p["b"]
            if i < len(masks) - 1:
                x = torch.relu(x)
        return x


@functools.lru_cache(maxsize=32)
def _mask_tensors(made: MADE, dtype, device) -> List[torch.Tensor]:
    """MADE's masks as tensors on ``device``, made once per configuration:
    a blocking copy from the host in every pass would wait for the card
    each time, D + 1 times a layer in the sequential inverse."""
    return [torch.as_tensor(m, dtype=dtype, device=device)
            for m in made._masks()]


def _sequential_inverse(features: int, z: torch.Tensor, column):
    """JAX's ``fori_loop`` over the features: x starts at zeros and pass
    ``i`` sets ``x[:, i]`` to ``column(x)[:, i]``."""
    x = torch.zeros_like(z)
    for i in range(features):
        x = x.clone()
        x[:, i] = column(x)[:, i]
    return x


@dataclasses.dataclass(frozen=True)
class MaskedAffineAutoregressive:
    """The affine autoregressive flow (IAF / MAF), scale
    ``sigmoid(s + 2) + 1e-3``."""

    features: int
    hidden_features: int
    num_blocks: int = 2

    def _net(self) -> MADE:
        return MADE(self.features, self.hidden_features, self.num_blocks,
                    output_multiplier=2)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"made": self._net().init_params(generator, dtype=dtype,
                                                device=device)}

    def _unconstrained(self, params, x):
        raw = self._net().apply(params["made"], x)
        raw = raw.reshape(-1, self.features, 2)
        scale = torch.sigmoid(raw[..., 0] + 2.0) + 1e-3
        return raw[..., 1], torch.log(scale)

    def forward(self, params, z):
        """The one-pass direction."""
        shift, log_scale = self._unconstrained(params, z)
        return z * torch.exp(log_scale) + shift, torch.sum(log_scale, dim=-1)

    def inverse(self, params, z):
        """The sequential inverse: feature i from features < i."""

        def column(x):
            shift, log_scale = self._unconstrained(params, x)
            return (z - shift) * torch.exp(-log_scale)

        x = _sequential_inverse(self.features, z, column)
        _, log_scale = self._unconstrained(params, x)
        return x, -torch.sum(log_scale, dim=-1)


@dataclasses.dataclass(frozen=True)
class MaskedPiecewiseRQSAutoregressive:
    """The autoregressive RQ-spline flow.  ``tails``: None (the compact
    interval [-tail_bound, tail_bound]), ``"linear"``, ``"circular"`` or
    one per dimension; circular or per-dimension tails featurise MADE's
    input by cos / sin at ``pi / tail_bound``."""

    features: int
    hidden_features: int
    num_bins: int = 10
    tails: Optional[object] = None
    tail_bound: float = 1.0
    num_blocks: int = 2
    init_identity: bool = True

    @property
    def _multiplier(self) -> int:
        if self.tails == "linear":
            return self.num_bins * 3 - 1
        if self.tails == "circular":
            return self.num_bins * 3
        return self.num_bins * 3 + 1

    def _net(self) -> MADE:
        scale = None
        if isinstance(self.tails, (list, tuple)) or self.tails == "circular":
            scale = float(np.pi / self.tail_bound)
        return MADE(self.features, self.hidden_features, self.num_blocks,
                    output_multiplier=self._multiplier,
                    periodic_scale=scale)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"made": self._net().init_params(
            generator, dtype=dtype, device=device,
            init_identity=self.init_identity,
            identity_bias=IDENTITY_DERIVATIVE_CONSTANT)}

    def _elementwise(self, params, cond_input, x, inverse: bool):
        """The spline of ``x`` under the parameters MADE gives
        ``cond_input``: (outputs, log-det summed over the features)."""
        raw = self._net().apply(params["made"], cond_input)
        raw = raw.reshape(x.shape[0], self.features, self._multiplier)
        nb = self.num_bins
        scale = 1.0 / math.sqrt(self.hidden_features)
        if self.tails is None:
            out, ld = rational_quadratic_spline(
                x, raw[..., :nb] * scale, raw[..., nb:2 * nb] * scale,
                raw[..., 2 * nb:], inverse=inverse, left=-self.tail_bound,
                right=self.tail_bound, bottom=-self.tail_bound,
                top=self.tail_bound)
            return out, torch.sum(ld, dim=-1)
        return unconstrained_rational_quadratic_spline_sum(
            x, raw[..., :nb], raw[..., nb:2 * nb], raw[..., 2 * nb:],
            inverse=inverse, tails=self.tails, tail_bound=self.tail_bound,
            scale=scale)

    def forward(self, params, z):
        return self._elementwise(params, z, z, inverse=False)

    def inverse(self, params, z):
        x = _sequential_inverse(
            self.features, z,
            lambda x: self._elementwise(params, x, z, inverse=True)[0])
        _, ld = self._elementwise(params, x, x, inverse=False)
        return x, -ld


class _MAF:
    """The MAF convention over ``_inner()``: the flow's ``forward`` is the
    inner transform's sequential inverse."""

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return self._inner().init_params(generator, dtype=dtype,
                                         device=device)

    def forward(self, params, z):
        return self._inner().inverse(params, z)

    def inverse(self, params, z):
        return self._inner().forward(params, z)


@dataclasses.dataclass(frozen=True)
class AutoregressiveRationalQuadraticSpline(_MAF):
    """The linear-tail autoregressive neural spline flow."""

    num_input_channels: int
    num_blocks: int
    num_hidden_channels: int
    num_bins: int = 8
    tail_bound: float = 3.0
    init_identity: bool = True

    def _inner(self) -> MaskedPiecewiseRQSAutoregressive:
        return MaskedPiecewiseRQSAutoregressive(
            features=self.num_input_channels,
            hidden_features=self.num_hidden_channels,
            num_bins=self.num_bins, tails="linear",
            tail_bound=self.tail_bound, num_blocks=self.num_blocks,
            init_identity=self.init_identity)


@dataclasses.dataclass(frozen=True)
class CircularAutoregressiveRationalQuadraticSpline(_MAF):
    """The circular-tail autoregressive neural spline flow: circular tails
    on ``ind_circ``, linear elsewhere, MADE's whole input featurised by
    cos / sin at ``pi / tail_bound`` (the fork's featurisation, which
    ignores ``ind``)."""

    num_input_channels: int
    num_blocks: int
    num_hidden_channels: int
    ind_circ: tuple = ()
    num_bins: int = 8
    tail_bound: float = 3.0
    init_identity: bool = True

    def _inner(self) -> MaskedPiecewiseRQSAutoregressive:
        circ = set(self.ind_circ)
        tails = tuple("circular" if i in circ else "linear"
                      for i in range(self.num_input_channels))
        return MaskedPiecewiseRQSAutoregressive(
            features=self.num_input_channels,
            hidden_features=self.num_hidden_channels,
            num_bins=self.num_bins, tails=tails,
            tail_bound=self.tail_bound, num_blocks=self.num_blocks,
            init_identity=self.init_identity)
