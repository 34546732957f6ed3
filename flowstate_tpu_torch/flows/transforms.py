"""Data-preprocessing flow layers: ``LogitTransform`` and ``Shift``.

Port of ``flowstate_tpu/flows/transforms.py``: ``LogitTransform`` (:24),
the logit dequantization flow with its exact log-det (forward: logit
space -> data in [0, 1]; inverse, the training direction: data -> logit
space), and ``Shift`` (:58).  Neither has parameters.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flowstate_tpu_torch.flows.base import ParameterFree
import torch.nn.functional as F

from flowstate_tpu_torch.flows.coupling import sum_except_batch


@dataclasses.dataclass(frozen=True)
class LogitTransform(ParameterFree):
    """``logit(alpha + (1 - 2 alpha) x)`` as a flow."""

    alpha: float = 0.05

    def forward(self, params, z):
        beta = 1.0 - 2.0 * self.alpha
        d = float(np.prod(z.shape[1:]))
        ls = sum_except_batch(F.logsigmoid(z))
        mls = sum_except_batch(F.logsigmoid(-z))
        log_det = -math.log(beta) * d + ls + mls
        return (torch.sigmoid(z) - self.alpha) / beta, log_det

    def inverse(self, params, z):
        beta = 1.0 - 2.0 * self.alpha
        x = self.alpha + beta * z
        logx = torch.log(x)
        log1mx = torch.log(1.0 - x)
        d = float(np.prod(z.shape[1:]))
        log_det = (math.log(beta) * d - sum_except_batch(logx)
                   - sum_except_batch(log1mx))
        return logx - log1mx, log_det


@dataclasses.dataclass(frozen=True)
class Shift(ParameterFree):
    """A constant shift: forward subtracts ``shift``, inverse adds it."""

    shift: float = -0.5

    def forward(self, params, z):
        return z - self.shift, torch.zeros_like(z[:, 0])

    def inverse(self, params, z):
        return z + self.shift, torch.zeros_like(z[:, 0])
