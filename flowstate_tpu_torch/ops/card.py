"""Which path a call takes: a hand-written CUDA kernel or its plain version.

The rule the spline kernel (``ops/splines.py``) and the EGNN kernel
(``flows/nets.py``) share: float32 tensors on the card with no gradient to
record take the kernel; CPU tensors, other dtypes and calls that autograd
records take the plain composition.
"""

from __future__ import annotations

import torch


def on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes_kernel(*tensors: torch.Tensor) -> bool:
    """The kernel's path: float32 tensors on the card and no gradient to
    record."""
    if not on_card(tensors[0]) or any(t.dtype != torch.float32
                                      for t in tensors):
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors))
