"""Flow adapters: ``Reverse`` and ``Composite``.

Port of ``flowstate_tpu/flows/base.py``: ``Reverse`` (:19) swaps a
layer's forward and inverse, ``Composite`` (:35) chains layers into one,
its parameters a list with one tree per layer.  Layers of the flow zoo are
configurations: ``init_params(generator, dtype=, device=)`` draws a tree,
``forward`` / ``inverse(params, z)`` return ``(z, log_det)``;
``flows.core.ParamLayer`` holds one with its tree inside a flow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


class ParameterFree:
    """The ``init_params`` of a layer without parameters: ``{}``."""

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {}


@dataclasses.dataclass(frozen=True)
class Reverse:
    """A layer with forward and inverse swapped."""

    layer: Any

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return self.layer.init_params(generator, dtype=dtype, device=device)

    def forward(self, params, z):
        return self.layer.inverse(params, z)

    def inverse(self, params, z):
        return self.layer.forward(params, z)


@dataclasses.dataclass(frozen=True)
class Composite:
    """Several layers fused into one; the layers' trees drawn in turn."""

    layers: Tuple[Any, ...]

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return [layer.init_params(generator, dtype=dtype, device=device)
                for layer in self.layers]

    def forward(self, params, z):
        log_det = torch.zeros_like(z[:, 0])
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, params, z):
        log_det = torch.zeros_like(z[:, 0])
        for layer, p in zip(reversed(self.layers), reversed(params)):
            z, ld = layer.inverse(p, z)
            log_det = log_det + ld
        return z, log_det
