"""Latent reshaping flows: ``Split``, ``Merge`` and ``Squeeze``.

Port of ``flowstate_tpu/flows/reshape.py``: ``Split`` divides the
features into two sets (channel halves, or the checkerboard colouring of
``_checkerboard`` :23, built in numpy as JAX builds it), ``Merge`` is
``Split`` reversed, and ``Squeeze`` moves 2 x 2 pixels of an NCHW image
into channels (its ``forward`` un-squeezes, as the reference's).  All
preserve volume (log-det 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flowstate_tpu_torch.flows.base import ParameterFree


def _checkerboard(shape, inv: bool) -> np.ndarray:
    """0/1 colouring over the non-batch dims."""
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    parity = sum(grids) % 2
    cb = (parity == 0).astype(np.int8)
    return 1 - cb if inv else cb


@dataclasses.dataclass(frozen=True)
class Split(ParameterFree):
    mode: str = "channel"

    def forward(self, params, z):
        if self.mode == "channel":
            z1, z2 = torch.chunk(z, 2, dim=1)
        elif self.mode == "channel_inv":
            z2, z1 = torch.chunk(z, 2, dim=1)
        elif "checkerboard" in self.mode:
            cb = _checkerboard(z.shape[1:], "inv" in self.mode)
            flat = z.reshape(z.shape[0], -1)
            cb_flat = torch.as_tensor(cb.reshape(-1).astype(bool),
                                      device=z.device)
            z1 = flat[:, cb_flat].reshape(*z.shape[:-1], -1)
            z2 = flat[:, ~cb_flat].reshape(*z.shape[:-1], -1)
        else:
            raise NotImplementedError(f"Mode {self.mode} is not implemented.")
        return [z1, z2], torch.zeros_like(z.reshape(z.shape[0], -1)[:, 0])

    def inverse(self, params, z):
        z1, z2 = z
        if self.mode == "channel":
            out = torch.cat([z1, z2], dim=1)
        elif self.mode == "channel_inv":
            out = torch.cat([z2, z1], dim=1)
        elif "checkerboard" in self.mode:
            out_shape = list(z1.shape)
            out_shape[-1] *= 2
            cb = _checkerboard(out_shape[1:], "inv" in self.mode)
            cb_flat = torch.as_tensor(cb.reshape(-1).astype(bool),
                                      device=z1.device)
            flat = z1.new_zeros((z1.shape[0], int(np.prod(out_shape[1:]))))
            flat[:, cb_flat] = z1.reshape(z1.shape[0], -1)
            flat[:, ~cb_flat] = z2.reshape(z2.shape[0], -1)
            out = flat.reshape(out_shape)
        else:
            raise NotImplementedError(f"Mode {self.mode} is not implemented.")
        return out, torch.zeros_like(out.reshape(out.shape[0], -1)[:, 0])


@dataclasses.dataclass(frozen=True)
class Merge(Split):
    """``Split`` with forward and inverse interchanged."""

    def forward(self, params, z):
        return Split.inverse(self, params, z)

    def inverse(self, params, z):
        return Split.forward(self, params, z)


@dataclasses.dataclass(frozen=True)
class Squeeze(ParameterFree):
    """2 x 2 space-to-channel squeeze of NCHW images: ``forward``
    un-squeezes (C/4, 2H, 2W), ``inverse`` squeezes (4C, H/2, W/2)."""

    def forward(self, params, z):
        b, c, h, w = z.shape
        z = z.reshape(b, c // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
        z = z.reshape(b, c // 4, 2 * h, 2 * w)
        return z, z.new_zeros(b)

    def inverse(self, params, z):
        b, c, h, w = z.shape
        z = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        z = z.reshape(b, 4 * c, h // 2, w // 2)
        return z, z.new_zeros(b)
