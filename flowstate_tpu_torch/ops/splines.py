"""Monotone rational-quadratic spline transforms (Durkan et al., NSF).

Port of ``flowstate_tpu/ops/splines.py``:

* ``rational_quadratic_spline``                — splines.py:83
* ``unconstrained_rational_quadratic_spline``  — splines.py:235, with
  ``linear``, ``circular`` and per-dimension tails (``_pad_derivatives``).

The same algebra as the JAX version, in plain PyTorch:

* the bin search is a comparison sum with ``eps`` added to the last knot
  only, then clipped (``torch.searchsorted`` puts inputs on a knot in
  another bin);
* the knots' endpoints are pinned exactly to the interval's bounds;
* the seven per-bin selects share one one-hot mask and a multiply-sum,
  exact because the other terms are zeros;
* the inverse solves the quadratic with ``disc = |b^2 - 4ac|``;
* inputs outside ``[-tail_bound, tail_bound]`` pass through with zero
  log-det, computed on clamped inputs and selected away.

``unconstrained_rational_quadratic_spline_sum`` is what the flows call: the
same spline on a (B, D) batch with parameters by stride (the net's raw
output sliced, or (D, bins) parameters expanded over the batch), widths
and heights times ``scale``, and the log-det summed over each row.  On the
card in float32, where no gradient is recorded, it is one launch of the
hand-written kernel (``ops/cuda_spline.py``, ``csrc/rq_spline.cu``); on
the CPU, in other dtypes and wherever autograd records, it is the
composition here, the kernel's plain version.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from flowstate_tpu_torch.ops import card, cuda_spline
from flowstate_tpu_torch.utils.profiling import annotate

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3

# softplus^{-1}(1 - min_derivative): the unnormalized derivative whose
# softplus makes the spline's slope exactly 1 (identity init, linear tails)
IDENTITY_DERIVATIVE_CONSTANT = math.log(math.expm1(1.0 - DEFAULT_MIN_DERIVATIVE))

# added to the last knot in the bin search
SEARCH_EPS = 1e-6

Tails = Union[str, Sequence[str]]


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = SEARCH_EPS) -> torch.Tensor:
    """The bin of each input: the count of knots at or below it, less one,
    with ``eps`` added to the last knot, clipped to ``[0, bins - 1]``."""
    num_bins = bin_locations.shape[-1] - 1
    last = torch.zeros(num_bins + 1, dtype=bin_locations.dtype,
                       device=bin_locations.device)
    last[-1] = eps
    idx = torch.sum(inputs[..., None] >= bin_locations + last, dim=-1) - 1
    return torch.clamp(idx, 0, num_bins - 1)


def _knots(unnormalized: torch.Tensor, min_size: float, left: float,
           right: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes, floored at ``min_size``, to knots on
    ``[left, right]`` with both endpoints pinned; returns (knots, sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * sizes
    cum = torch.cumsum(sizes, dim=-1)
    cum = (right - left) * cum + left
    lead = cum[..., :1]
    cum = torch.cat([torch.full_like(lead, left), cum[..., :-1],
                     torch.full_like(lead, right)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone RQ spline on ``[left, right] -> [bottom, top]``.

    inputs (...,) inside the interval; widths and heights (..., bins);
    derivatives (..., bins + 1).  Returns (outputs, logabsdet), shaped like
    ``inputs``.
    """
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError("Minimal bin width too large for the number of bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError("Minimal bin height too large for the number of bins")

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, left, right)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, bottom,
                                 top)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    onehot = (bin_idx[..., None] == torch.arange(
        num_bins, device=inputs.device)).to(inputs.dtype)

    # the seven selects as one product and one sum over a stacked axis
    (input_cumwidths, input_bin_widths, input_cumheights, input_delta,
     input_derivatives, input_derivatives_plus_one, input_heights) = torch.sum(
        torch.stack([cumwidths[..., :-1], widths, cumheights[..., :-1],
                     heights / widths, derivatives[..., :-1],
                     derivatives[..., 1:], heights]) * onehot, dim=-1)

    d_sum = input_derivatives + input_derivatives_plus_one - 2.0 * input_delta

    if inverse:
        shifted = inputs - input_cumheights
        a = shifted * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - shifted * d_sum
        c = -input_delta * shifted
        discriminant = torch.abs(b * b - 4.0 * a * c)
        root = (2.0 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1.0 - root)
        denominator = input_delta + d_sum * theta_one_minus_theta
        derivative_numerator = input_delta ** 2 * (
            input_derivatives_plus_one * root ** 2
            + 2.0 * input_delta * theta_one_minus_theta
            + input_derivatives * (1.0 - root) ** 2)
        logabsdet = (torch.log(derivative_numerator)
                     - 2.0 * torch.log(denominator))
        return outputs, -logabsdet

    theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1.0 - theta)
    numerator = input_heights * (input_delta * theta ** 2
                                 + input_derivatives * theta_one_minus_theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    outputs = input_cumheights + numerator / denominator
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2.0 * input_delta * theta_one_minus_theta
        + input_derivatives * (1.0 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2.0 * torch.log(denominator)
    return outputs, logabsdet


def _pad_derivatives(unnormalized_derivatives: torch.Tensor, tails: Tails,
                     circular_tie: bool = True) -> torch.Tensor:
    """The tail rule on the derivative parameters.

    "linear": both ends padded with the identity constant; "circular": the
    first slot repeated at the end.  A per-dimension list takes
    (..., D, bins + 1) slots: linear dims get both ends set to the
    constant, circular dims the last tied to the first (``circular_tie``;
    False leaves it free, as the reference fork's effective behaviour).
    """
    constant = IDENTITY_DERIVATIVE_CONSTANT
    d = unnormalized_derivatives
    if isinstance(tails, str):
        if tails == "linear":
            const = torch.full_like(d[..., :1], constant)
            return torch.cat([const, d, const], dim=-1)
        if tails == "circular":
            return torch.cat([d, d[..., :1]], dim=-1)
        raise NotImplementedError(f"{tails} tails are not implemented.")
    tails = list(tails)
    if not all(t in ("circular", "linear") for t in tails):
        raise NotImplementedError("per-dim tails must be linear/circular")
    first, last = d[..., :1], d[..., -1:]
    if all(t == "circular" for t in tails):
        # the flows' case: no mask, so no host-to-device copy per call
        new_first, new_last = first, (first if circular_tie else last)
    else:
        const = torch.full_like(first, constant)
        lin = torch.tensor([t == "linear" for t in tails],
                           device=d.device)[:, None]
        new_first = torch.where(lin, const, first)
        new_last = torch.where(lin, const, last)
        if circular_tie:
            circ = torch.tensor([t == "circular" for t in tails],
                                device=d.device)[:, None]
            new_last = torch.where(circ, new_first, new_last)
    return torch.cat([new_first, d[..., 1:-1], new_last], dim=-1)


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: Tails = "linear",
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    circular_tie: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RQ spline on ``[-tail_bound, tail_bound]``, identity outside (a span
    ``flow.spline``)."""
    with annotate("flow.spline"):
        inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
        derivatives = _pad_derivatives(unnormalized_derivatives, tails,
                                       circular_tie=circular_tie)
        spline_out, spline_logdet = rational_quadratic_spline(
            torch.clamp(inputs, -tail_bound, tail_bound),
            unnormalized_widths, unnormalized_heights, derivatives,
            inverse=inverse, left=-tail_bound, right=tail_bound,
            bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
            min_bin_height=min_bin_height, min_derivative=min_derivative)
        outputs = torch.where(inside, spline_out, inputs)
        logabsdet = torch.where(inside, spline_logdet,
                                torch.zeros_like(spline_logdet))
        return outputs, logabsdet


def unconstrained_rational_quadratic_spline_sum(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: Tails = "linear",
    tail_bound: float = 1.0,
    scale: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
    circular_tie: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``unconstrained_rational_quadratic_spline`` of (B, D) ``inputs``
    with the widths and heights times ``scale``; returns the outputs and
    the log-det summed over each row, (B,).  Parameters (B, D, bins) and
    (B, D, slots) may be views: slices of the net's raw output, or (D, ...)
    parameters expanded over the batch.  float32 CUDA tensors with no
    gradient to record take one launch of ``cuda_spline.rq_spline_kernel``
    (a span ``flow.spline``); the rest take the plain composition."""
    params = (unnormalized_widths, unnormalized_heights,
              unnormalized_derivatives)
    if card.takes_kernel(inputs, *params):
        with annotate("flow.spline"):
            return cuda_spline.rq_spline_kernel(
                inputs, *params, inverse=inverse, tails=tails,
                tail_bound=tail_bound, scale=scale,
                circular_tie=circular_tie, min_bin_width=min_bin_width,
                min_bin_height=min_bin_height,
                min_derivative=min_derivative, eps=SEARCH_EPS,
                identity_derivative=IDENTITY_DERIVATIVE_CONSTANT)
    widths, heights, derivatives = params
    if scale != 1.0:
        widths, heights = widths * scale, heights * scale
    outputs, logabsdet = unconstrained_rational_quadratic_spline(
        inputs, widths, heights, derivatives, inverse=inverse, tails=tails,
        tail_bound=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative,
        circular_tie=circular_tie)
    return outputs, torch.sum(logabsdet.reshape(logabsdet.shape[0], -1),
                              dim=-1)
