"""The circular rational-quadratic-spline coupling flow's density, in the
dtype of its inputs (the check runs it in float64).

A flow of K couplings over the torus [-b, b]^D (b the half box, D = 2N)
with a uniform base: ``log q(x) = -D log(2b) + sum of the K couplings'
log-determinants``, the couplings taken from layer K-1 down to 0 (the data
to latent direction).  Coupling k, on x:

* the identity half is the even features, the transformed half the odd
  ones;
* the identity half goes through the layer's own spline (its ``uncond``
  widths, heights and derivatives, no scaling);
* the conditioner maps the identity half's periodic features
  ``[cos(pi x / b), sin(pi x / b)]`` to 3 bins + 1 values per transformed
  feature: widths and heights (scaled by 1 / sqrt(hidden)), then bins + 1
  derivatives;
* the transformed half goes through that spline;
* the halves go back to their places and the features roll left by D / 2.

A spline has circular tails: the last derivative is tied to the first;
bins are floored at 1e-3 of the interval, slopes at 1e-3 above a
softplus; an input outside [-b, b] passes with log-det 0.

Conditioners, on a (B, F) input of F = D features:

* ``residual``: a linear to the hidden width, then blocks of
  ``t + l2(relu(ln(l1(relu(ln(t))))))``, ``ln`` a layer norm without
  affine and eps 1e-3, then the final linear;
* ``transformer``: each feature a token embedded by a (1, E) linear,
  blocks of ``t + proj(attention(qkv(ln(t))))`` (H heads, scores over
  sqrt(E / H)) and ``t + ff2(gelu_tanh(ff1(ln(t))))``, then one linear of
  the flattened (F E) sequence; no positional encoding.

``params`` is the flow's tree as the benchmark made it: ``{"net": ...,
"uncond": {...}}`` with every leaf stacked on a leading K axis, linears
``{"w": (K, in, out), "b": (K, out)}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MIN_BIN = 1e-3
MIN_DERIVATIVE = 1e-3
LN_EPS = 1e-3


def _linear(p, k: int, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"][k] + p["b"][k]


def _ln(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS)


def residual_net(p, k: int, x: torch.Tensor) -> torch.Tensor:
    t = _linear(p["initial"], k, x)
    for blk in p["blocks"]:
        r = _linear(blk["l1"], k, torch.relu(_ln(t)))
        r = _linear(blk["l2"], k, torch.relu(_ln(r)))
        t = t + r
    return _linear(p["final"], k, t)


def transformer_net(p, k: int, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s = x.shape
    t = x[..., None] * p["embed"]["w"][k][0] + p["embed"]["b"][k]  # (B, S, E)
    e = t.shape[-1]
    c = e // heads
    for blk in p["blocks"]:
        qkv = _linear(blk["qkv"], k, _ln(t))
        q, kk, v = (a.reshape(b, s, heads, c).transpose(1, 2)
                    for a in qkv.split(e, dim=-1))
        att = torch.softmax(q @ kk.transpose(-2, -1) / math.sqrt(c), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, s, e)
        t = t + _linear(blk["proj"], k, o)
        t = t + _linear(blk["ff2"], k, F.gelu(_linear(blk["ff1"], k, _ln(t)),
                                               approximate="tanh"))
    return _linear(p["final"], k, t.reshape(b, s * e))


def _knots(raw: torch.Tensor, bound: float):
    bins = raw.shape[-1]
    size = MIN_BIN + (1.0 - MIN_BIN * bins) * torch.softmax(raw, dim=-1)
    cum = (2.0 * bound) * torch.cumsum(size, dim=-1) - bound
    cum = torch.cat([torch.full_like(cum[..., :1], -bound), cum[..., :-1],
                     torch.full_like(cum[..., :1], bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def spline(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
           d: torch.Tensor, bound: float):
    """The monotone RQ spline of [-bound, bound] onto itself, data to
    latent, with circular tails: ``(y, log|dy/dx|)`` elementwise."""
    inside = (x >= -bound) & (x <= bound)
    xc = torch.clamp(x, -bound, bound)
    d = torch.cat([d[..., :1], d[..., 1:-1], d[..., :1]], dim=-1)
    cw, wid = _knots(w, bound)
    ch, hei = _knots(h, bound)
    der = MIN_DERIVATIVE + F.softplus(d)
    bins = w.shape[-1]
    edges = cw + torch.cat([torch.zeros_like(cw[..., :-1]),
                            torch.full_like(cw[..., -1:], 1e-6)], dim=-1)
    idx = torch.clamp((xc[..., None] >= edges).sum(-1) - 1, 0, bins - 1)

    def at(t):
        return torch.gather(t, -1, idx[..., None])[..., 0]

    x0, bw, y0, bh = at(cw[..., :-1]), at(wid), at(ch[..., :-1]), at(hei)
    d0, d1 = at(der[..., :-1]), at(der[..., 1:])
    delta = bh / bw
    theta = (xc - x0) / bw
    tt = theta * (1.0 - theta)
    denom = delta + (d0 + d1 - 2.0 * delta) * tt
    y = y0 + bh * (delta * theta ** 2 + d0 * tt) / denom
    num = delta ** 2 * (d1 * theta ** 2 + 2.0 * delta * tt
                        + d0 * (1.0 - theta) ** 2)
    logdet = torch.log(num) - 2.0 * torch.log(denom)
    return (torch.where(inside, y, x),
            torch.where(inside, logdet, torch.zeros_like(logdet)))


def log_prob(params, x: torch.Tensor, bound: float, net: str, hidden: int,
             bins: int, heads: int = None) -> torch.Tensor:
    """log q of a (B, D) batch in the flow's centred frame (``heads``: the
    transformer's)."""
    b, dim = x.shape
    ident, trans = torch.arange(0, dim, 2), torch.arange(1, dim, 2)
    order = torch.argsort(torch.cat([ident, trans]))
    u = params["uncond"]
    K = u["widths"].shape[0]
    logq = torch.full((b,), -dim * math.log(2.0 * bound), dtype=x.dtype,
                      device=x.device)
    for k in reversed(range(K)):
        xi, xt = x[:, ident], x[:, trans]
        feats = torch.cat([torch.cos(math.pi / bound * xi),
                           torch.sin(math.pi / bound * xi)], dim=-1)
        if net == "residual":
            raw = residual_net(params["net"], k, feats)
        elif net == "transformer":
            raw = transformer_net(params["net"], k, feats, heads)
        else:
            raise ValueError(f"no reference conditioner {net!r}")
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
