"""The torus EGNN conditioner and the circular spline flow it conditions,
in the dtype of the inputs (the check runs them in float64).  Any float32
product runs with TF32 off.

The conditioner of coupling k, on the identity half's N raw coordinates
``x_id`` (B, N) of the torus [-b, b]: with ``c = (pi / b) x_id``, node i
the scalar ``c_i``,

* ``h_i = W_e [cos c_i, sin c_i] + b_e``;
* ``r_ij = (c_i - c_j) - 2 pi round((c_i - c_j) / 2 pi)``, rounding half
  to even, and ``e_ij = [sin r_ij, cos r_ij]``;
* for each of the L layers: ``m_ij = SiLU(W_m [h_i, h_j, e_ij] + b_m)``,
  ``a_i = sum over j != i of m_ij``, ``h_i <- h_i + SiLU(W_u [h_i, a_i]
  + b_u)``;
* ``out = W_f mean_i h_i + b_f``.

It follows Satorras, Hoogeboom & Welling, "E(n) Equivariant Graph Neural
Networks" (arXiv:2102.09844), with these departures: the edge and node
functions are one linear and a SiLU each, not two-layer MLPs; ``[sin,
cos]`` of the wrapped difference stands in for the squared distance;
there is no coordinate update; the node update is residual; the readout is
a mean over the nodes.

``params`` is the flow's tree as the benchmark made it
(``benchmark/gnn_weights.py``): ``{"net": {"embed", "layers": [{"msg",
"upd"}, ...], "final"}, "uncond": {...}}``, every leaf stacked on a
leading K axis, linears ``{"w": (K, in, out), "b": (K, out)}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.flow import spline


def _linear(p, k: int, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"][k] + p["b"][k]


def _gnn(p, k: int, x_id: torch.Tensor, bound: float) -> torch.Tensor:
    b, n = x_id.shape
    c = (math.pi / bound) * x_id
    h = _linear(p["embed"], k, torch.stack([torch.cos(c), torch.sin(c)],
                                           dim=-1))            # (B, N, H)
    d = c[:, :, None] - c[:, None, :]                          # c_i - c_j
    r = d - 2 * math.pi * torch.round(d / (2 * math.pi))
    e = torch.stack([torch.sin(r), torch.cos(r)], dim=-1)      # (B, N, N, 2)
    others = ~torch.eye(n, dtype=torch.bool, device=x_id.device)
    for layer in p["layers"]:
        pair = (b, n, n, h.shape[-1])
        m = F.silu(_linear(layer["msg"], k, torch.cat(
            [h[:, :, None].expand(pair), h[:, None].expand(pair), e], dim=-1)))
        a = torch.where(others[..., None], m, torch.zeros_like(m)).sum(2)
        h = h + F.silu(_linear(layer["upd"], k, torch.cat([h, a], dim=-1)))
    return _linear(p["final"], k, h.mean(1))


def gnn_net(p, k: int, x_id: torch.Tensor, bound: float) -> torch.Tensor:
    """Conditioner k's raw spline parameters of (B, N) coordinates, its
    products without TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _gnn(p, k, x_id, bound)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def log_prob(params, x: torch.Tensor, bound: float, hidden: int,
             bins: int) -> torch.Tensor:
    """log q of a (B, D) batch in the flow's centred frame: the couplings of
    ``reference/flow.py::log_prob`` with the EGNN as their conditioner, on
    the identity half's raw coordinates."""
    b, dim = x.shape
    ident, trans = torch.arange(0, dim, 2), torch.arange(1, dim, 2)
    order = torch.argsort(torch.cat([ident, trans]))
    u = params["uncond"]
    K = u["widths"].shape[0]
    logq = torch.full((b,), -dim * math.log(2.0 * bound), dtype=x.dtype,
                      device=x.device)
    for k in reversed(range(K)):
        xi, xt = x[:, ident], x[:, trans]
        raw = gnn_net(params["net"], k, xi, bound)
        raw = raw.reshape(b, len(trans), 3 * bins + 1)
        scale = 1.0 / math.sqrt(hidden)
        yt, ld_t = spline(xt, raw[..., :bins] * scale,
                          raw[..., bins:2 * bins] * scale, raw[..., 2 * bins:],
                          bound)
        yi, ld_i = spline(xi, u["widths"][k].expand(b, -1, -1),
                          u["heights"][k].expand(b, -1, -1),
                          u["derivatives"][k].expand(b, -1, -1), bound)
        y = torch.cat([yi, yt], dim=1)[:, order]
        x = torch.cat([y[:, dim // 2:], y[:, :dim // 2]], dim=1)
        logq = logq + ld_t.sum(-1) + ld_i.sum(-1)
    inside = ((x >= -bound) & (x <= bound)).all(-1)
    return torch.where(inside, logq, torch.full_like(logq, -math.inf))
