"""Image flows on NCHW tensors: ``ConvNet2d``, ``ConvResidualNet``,
``ActNormImage`` and ``GlowBlock``.

Port of ``flowstate_tpu/flows/image.py``: the conv stack with LeakyReLU
and a zero-initialised final conv (:51), the pre-activation conv residual
net (:81), the per-channel ActNorm with Glow's data init at ddof 0
(:130), and Glow's block (:163): a channel-split affine coupling (the
sigmoid(raw + 2) or exp scale map), the invertible 1 x 1 conv
(``mixing.Invertible1x1Conv``, LU) and the ActNorm.

A conv is ``{"w": (out, in, k, k), "b": (out,)}``, run by
``nets.conv2d`` in the input's dtype: JAX's ``_conv`` asks for float32
results (``preferred_element_type``), which fails on float64 inputs
(ROADMAP R15), and on the card the port's float32 convolutions run
without TF32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from flowstate_tpu_torch.flows.mixing import Invertible1x1Conv
from flowstate_tpu_torch.flows.nets import _uniform, conv2d


def _conv_init(generator, in_c: int, out_c: int, k: int, zeros=False,
               dtype=torch.float32, device="cuda"):
    """``nn.Conv2d``'s default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w
    and b, or zeros."""
    if zeros:
        return {"w": torch.zeros((out_c, in_c, k, k), dtype=dtype,
                                 device=device),
                "b": torch.zeros((out_c,), dtype=dtype, device=device)}
    bound = 1.0 / math.sqrt(in_c * k * k)
    return {"w": _uniform((out_c, in_c, k, k), bound, generator, dtype,
                          device),
            "b": _uniform((out_c,), bound, generator, dtype, device)}


def _conv(params, x, k):
    return conv2d(x, params["w"], padding=k // 2) + params["b"][
        None, :, None, None]


@dataclasses.dataclass(frozen=True)
class ConvNet2d:
    """Conv stack; channels (in, hidden..., out), an odd kernel a layer,
    LeakyReLU between, the last conv zero-initialised."""

    channels: Tuple[int, ...]
    kernel_size: Tuple[int, ...] = (3, 1, 3)
    leaky: float = 0.0
    init_zeros: bool = True

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        n = len(self.channels) - 1
        return [_conv_init(generator, self.channels[i], self.channels[i + 1],
                           self.kernel_size[i],
                           zeros=(self.init_zeros and i == n - 1),
                           dtype=dtype, device=device)
                for i in range(n)]

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        for i, p in enumerate(params):
            x = _conv(p, x, self.kernel_size[i])
            if i < len(params) - 1:
                x = torch.where(x >= 0, x, self.leaky * x)
        return x


@dataclasses.dataclass(frozen=True)
class ConvResidualNet:
    """Pre-activation conv residual net: a 1 x 1 conv, ``num_blocks``
    blocks of two 3 x 3 convs (the second U(-1e-3, 1e-3)), a 1 x 1
    conv."""

    in_channels: int
    out_channels: int
    hidden_channels: int
    num_blocks: int = 2

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        h = self.hidden_channels
        params = {"initial": _conv_init(generator, self.in_channels, h, 1,
                                        dtype=dtype, device=device)}
        params["blocks"] = [
            {"c1": _conv_init(generator, h, h, 3, dtype=dtype,
                              device=device),
             "c2": {"w": _uniform((h, h, 3, 3), 1e-3, generator, dtype,
                                  device),
                    "b": _uniform((h,), 1e-3, generator, dtype, device)}}
            for _ in range(self.num_blocks)]
        params["final"] = _conv_init(generator, h, self.out_channels, 1,
                                     dtype=dtype, device=device)
        return params

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        t = _conv(params["initial"], x, 1)
        for blk in params["blocks"]:
            r = _conv(blk["c1"], torch.relu(t), 3)
            t = t + _conv(blk["c2"], torch.relu(r), 3)
        return _conv(params["final"], t, 1)


@dataclasses.dataclass(frozen=True)
class ActNormImage:
    """Per-channel affine flow ``z e^s + t`` on NCHW; ``init_params_from_
    data`` maps a batch to zero mean and unit deviation per channel."""

    num_channels: int

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        return {"s": torch.zeros((self.num_channels,), dtype=dtype,
                                 device=device),
                "t": torch.zeros((self.num_channels,), dtype=dtype,
                                 device=device)}

    def init_params_from_data(self, z: torch.Tensor):
        s = -torch.log(torch.std(z, dim=(0, 2, 3), correction=0) + 1e-6)
        t = -torch.mean(z, dim=(0, 2, 3)) * torch.exp(s)
        return {"s": s, "t": t}

    def _log_det(self, params, z, sign: float):
        hw = z.shape[2] * z.shape[3]
        return (sign * hw * torch.sum(params["s"])).expand(z.shape[0])

    def forward(self, params, z):
        s = params["s"][None, :, None, None]
        t = params["t"][None, :, None, None]
        return z * torch.exp(s) + t, self._log_det(params, z, 1.0)

    def inverse(self, params, z):
        s = params["s"][None, :, None, None]
        t = params["t"][None, :, None, None]
        return (z - t) * torch.exp(-s), self._log_det(params, z, -1.0)


@dataclasses.dataclass(frozen=True)
class GlowBlock:
    """One Glow block on NCHW images: the affine coupling, the 1 x 1
    conv (skipped on one channel) and the ActNorm; its tree is ``{"net",
    "conv1x1", "actnorm"}``."""

    channels: int
    hidden_channels: int
    scale: bool = True
    scale_map: str = "sigmoid"
    use_lu: bool = True
    leaky: float = 0.0

    def _net(self) -> ConvNet2d:
        num_param = 2 if self.scale else 1
        c1 = (self.channels + 1) // 2
        c2 = self.channels // 2
        return ConvNet2d(
            channels=(c1, self.hidden_channels, self.hidden_channels,
                      num_param * c2),
            kernel_size=(3, 1, 3), leaky=self.leaky, init_zeros=True)

    def _conv1x1(self) -> Invertible1x1Conv:
        return Invertible1x1Conv(self.channels, use_lu=self.use_lu)

    def _actnorm(self) -> ActNormImage:
        return ActNormImage(self.channels)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"):
        kw = dict(dtype=dtype, device=device)
        return {"net": self._net().init_params(generator, **kw),
                "conv1x1": self._conv1x1().init_params(generator, **kw),
                "actnorm": self._actnorm().init_params(generator, **kw)}

    def _coupling(self, params, z, inverse: bool):
        c1 = (self.channels + 1) // 2
        z1, z2 = z[:, :c1], z[:, c1:]
        raw = self._net().apply(params["net"], z1)
        if not self.scale:
            z2 = z2 - raw if inverse else z2 + raw
            return torch.cat([z1, z2], dim=1), z.new_zeros(z.shape[0])
        shift, scale_raw = raw[:, 0::2], raw[:, 1::2]
        if self.scale_map == "sigmoid":
            s = torch.sigmoid(scale_raw + 2.0)
            ld = torch.sum(torch.log(s), dim=(1, 2, 3))
            if inverse:
                z2 = (z2 - shift) * s
            else:
                z2, ld = z2 / s + shift, -ld
        else:  # exp
            ld = torch.sum(scale_raw, dim=(1, 2, 3))
            if inverse:
                z2, ld = (z2 - shift) * torch.exp(-scale_raw), -ld
            else:
                z2 = z2 * torch.exp(scale_raw) + shift
        return torch.cat([z1, z2], dim=1), ld

    def forward(self, params, z):
        z, log_det = self._coupling(params, z, inverse=False)
        if self.channels > 1:
            z, ld = self._conv1x1().forward(params["conv1x1"], z)
            log_det = log_det + ld
        z, ld = self._actnorm().forward(params["actnorm"], z)
        return z, log_det + ld

    def inverse(self, params, z):
        z, log_det = self._actnorm().inverse(params["actnorm"], z)
        if self.channels > 1:
            z, ld = self._conv1x1().inverse(params["conv1x1"], z)
            log_det = log_det + ld
        z, ld = self._coupling(params, z, inverse=True)
        return z, log_det + ld
