"""The rational-quadratic spline's hand-written CUDA kernel.

``rq_spline_kernel`` launches ``csrc/rq_spline.cu``: one call of
``ops/splines.py::unconstrained_rational_quadratic_spline`` with the
log-det summed over each row's dimensions, as
``unconstrained_rational_quadratic_spline_sum`` computes it, in one launch
on the current stream.  It replaces no TPU kernel (XLA fused the JAX
package's jnp spline on the TPU); its plain version is the composition in
``ops/splines.py``, which CPU tensors and calls that record a gradient
take.  A call is its checks, two ``torch.empty`` and one launch;
``LAUNCHES`` counts launches.

The parameters are read by stride, the last axis contiguous: the net's raw
output (B, D, 3 bins + 1) sliced into widths, heights and derivatives
without a copy, or (D, bins) parameters expanded over the batch (stride
0).  Widths and heights are multiplied by ``scale`` first.  The kernel
takes float32, the flows' dtype on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from flowstate_tpu_torch.ops import card

LAUNCHES = 0      # kernel launches in this process (one per call)

MAX_BINS = 32     # a bin a lane of a warp
# csrc/rq_spline.cu's tail rules: every dimension linear, every dimension
# circular, one rule per dimension
TAILS_LINEAR, TAILS_CIRCULAR, TAILS_PER_DIM = 0, 1, 2


class _SplineParams(ctypes.Structure):
    """Mirror of ``SplineParams`` in ``csrc/rq_spline.cu``."""

    _fields_ = [(name, ctypes.c_longlong) for name in
                ("batch", "x_sb", "x_sd", "w_sb", "w_sd", "h_sb", "h_sd",
                 "d_sb", "d_sd")] + [
        (name, ctypes.c_int) for name in
        ("dims", "bins", "slots", "tails", "tie", "inverse")] + [
        (name, ctypes.c_double) for name in
        ("scale", "tail_bound", "min_bin_width", "min_bin_height",
         "min_derivative", "identity_derivative", "eps")]


def tail_rule(tails: Union[str, Sequence[str]], dims: int, bins: int
              ) -> Tuple[int, int, Optional[Tuple[bool, ...]]]:
    """(rule, derivative slots a dimension, per-dimension linear flags or
    None) of ``tails``, as ``_pad_derivatives`` reads them."""
    if isinstance(tails, str):
        if tails == "linear":
            if bins < 2:       # as the plain spline, which pads a slot
                raise ValueError("linear tails take 2 or more bins")
            return TAILS_LINEAR, bins - 1, None
        if tails == "circular":
            return TAILS_CIRCULAR, bins, None
        raise NotImplementedError(f"{tails} tails are not implemented.")
    tails = list(tails)
    if not all(t in ("circular", "linear") for t in tails):
        raise NotImplementedError("per-dim tails must be linear/circular")
    if len(tails) != dims:
        raise ValueError(f"{len(tails)} tails for {dims} dimensions")
    linear = tuple(t == "linear" for t in tails)
    return TAILS_PER_DIM, bins + 1, (linear if any(linear) else None)


def pack(inputs: torch.Tensor, widths: torch.Tensor, heights: torch.Tensor,
         derivatives: torch.Tensor, inverse: bool, tails, tail_bound: float,
         scale: float, circular_tie: bool, min_bin_width: float,
         min_bin_height: float, min_derivative: float, eps: float,
         identity_derivative: float
         ) -> Tuple[_SplineParams, Optional[Tuple[bool, ...]]]:
    """The kernel's parameters and linear flags for one call; raises
    ValueError on what the kernel does not take."""
    if inputs.ndim != 2:
        raise ValueError(f"inputs must be (B, D), got {tuple(inputs.shape)}")
    b, dims = inputs.shape
    if widths.ndim != 3 or widths.shape[:2] != (b, dims):
        raise ValueError(f"widths must be (B, D, bins) = ({b}, {dims}, "
                         f"bins), got {tuple(widths.shape)}")
    bins = widths.shape[2]
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"the kernel takes 1 to {MAX_BINS} bins, got {bins}")
    if min_bin_width * bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")
    rule, slots, linear = tail_rule(tails, dims, bins)
    if heights.shape != widths.shape:
        raise ValueError(f"heights must be {tuple(widths.shape)}, got "
                         f"{tuple(heights.shape)}")
    if derivatives.shape != (b, dims, slots):
        raise ValueError(f"derivatives must be ({b}, {dims}, {slots}) for "
                         f"these tails, got {tuple(derivatives.shape)}")
    for t in (inputs, widths, heights, derivatives):
        if t.dtype != torch.float32:
            raise ValueError(f"the kernel takes float32, got {t.dtype}")
    for t in (widths, heights, derivatives):
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError("the parameters' last axis must be contiguous")
    params = _SplineParams(
        batch=b, x_sb=inputs.stride(0), x_sd=inputs.stride(1),
        w_sb=widths.stride(0), w_sd=widths.stride(1),
        h_sb=heights.stride(0), h_sd=heights.stride(1),
        d_sb=derivatives.stride(0), d_sd=derivatives.stride(1),
        dims=dims, bins=bins, slots=slots, tails=rule,
        tie=int(bool(circular_tie)), inverse=int(bool(inverse)),
        scale=scale, tail_bound=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative,
        identity_derivative=identity_derivative, eps=eps)
    return params, linear


@functools.lru_cache(maxsize=None)
def _linear_flags(linear: Tuple[bool, ...], device: torch.device
                  ) -> torch.Tensor:
    """The per-dimension linear flags on the card, copied there once."""
    return torch.tensor(linear, dtype=torch.uint8, device=device)


def _library():
    from flowstate_tpu_torch.kernels import build

    return build.build().libs["rq_spline"]


_ENTRY = None     # the bound entry point, set at the first launch


def _launch(params: _SplineParams, tensors: Sequence[Optional[torch.Tensor]],
            stream: int) -> None:
    """One launch of the kernel on ``stream``: ``tensors`` are (inputs,
    widths, heights, derivatives, linear flags, outputs, log-dets), the
    flags None or a tensor; raises if the launch returns a cudaError."""
    global LAUNCHES, _ENTRY
    if _ENTRY is None:
        fn = _library().flowstate_rq_spline
        fn.argtypes = [ctypes.POINTER(_SplineParams)] + [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        _ENTRY = fn
    rc = _ENTRY(ctypes.byref(params),
                *[None if t is None else t.data_ptr() for t in tensors],
                stream)
    if rc != 0:
        raise RuntimeError(f"rq_spline launch failed: cudaError {rc}")
    LAUNCHES += 1


def _launch_on(device: torch.device, params: _SplineParams,
               tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """``_launch`` on ``device``'s current stream."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    with torch.cuda.device(index):
        _launch(params, tensors, torch.cuda.current_stream(index).cuda_stream)


def rq_spline_kernel(inputs: torch.Tensor, widths: torch.Tensor,
                     heights: torch.Tensor, derivatives: torch.Tensor, *,
                     inverse: bool, tails, tail_bound: float, scale: float,
                     circular_tie: bool, min_bin_width: float,
                     min_bin_height: float, min_derivative: float,
                     eps: float, identity_derivative: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Outputs (B, D) and log-dets summed over each row (B,) of the spline
    on a (B, D) float32 CUDA batch, in one launch on the current stream;
    the arguments as ``ops/splines.py`` gives them."""
    params, linear = pack(inputs, widths, heights, derivatives, inverse,
                          tails, tail_bound, scale, circular_tie,
                          min_bin_width, min_bin_height, min_derivative, eps,
                          identity_derivative)
    tensors = (inputs, widths, heights, derivatives)
    if not all(card.on_card(t) for t in tensors):
        raise ValueError("rq_spline_kernel takes CUDA tensors, got "
                         f"{inputs.device}; the plain spline takes CPU "
                         "tensors")
    if any(t.device != inputs.device for t in tensors):
        raise ValueError("the spline's tensors lie on more than one device")
    b, dims = inputs.shape
    out = torch.empty((b, dims), dtype=inputs.dtype, device=inputs.device)
    logdet = torch.empty((b,), dtype=inputs.dtype, device=inputs.device)
    if b == 0:
        return out, logdet
    flags = None if linear is None else _linear_flags(linear, inputs.device)
    _launch_on(inputs.device, params,
               (inputs, widths, heights, derivatives, flags, out, logdet))
    return out, logdet
