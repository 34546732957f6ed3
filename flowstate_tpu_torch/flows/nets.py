"""The coupling layers' parameter networks, as functions of a parameter tree.

Port of ``flowstate_tpu/flows/nets.py``: ``ResidualNet`` (:71), ``MLP``
(:176), ``TransformerNet`` (:199), ``TorusEGNN`` (:259),
``ConstScaleLayer`` (:327), ``clamp_exp`` / ``ClampExp`` (:336-341),
``PeriodicFeaturesElementwise`` (:345), ``PeriodicFeaturesCat`` (:358),
with ``_linear_init`` (:36), ``_linear`` (:47) and ``_layer_norm`` (:61).

Parameters are a tree of tensors shaped like the JAX pytree: a linear
layer is ``{"w": (in, out), "b": (out,)}`` (the transpose of
``nn.Linear.weight``).  Every net's ``apply`` also takes a tree whose
leaves carry a leading axis of G nets, ``w`` (G, in, out) and ``b``
(G, out), with inputs (G, B, ...): the paired flow step runs two layers'
nets in one batched product that way.  ``_linear`` lines the net axis up
with inputs of any rank (the transformer's activations are (G, B, D, E)).

With ``context_features`` the residual net is conditional, as the JAX
net's (nets.py:145-146, 167-169): the context joins the featurised input
of the ``initial`` layer, and each block's residual is gated by
``sigmoid(ctx(context))``, a linear ``blk["ctx"]`` of shape (ctx, hidden)
(a GLU).  The context itself is not featurised.  The transformer and the
gnn take no context, as in JAX.

``compute_dtype="bfloat16"`` (the residual net only, as in JAX) runs every
matmul and hidden activation in bf16: operands and outputs of the linears
in bf16, layer-norm statistics in float32, the net's output cast back to
the input's dtype.  Parameters stay in their own dtype.

``TorusEGNN.apply`` opens a span ``flow.gnn.messages`` around its message
passing (the relative coordinates through the last layer's update) and
adds the messages it computes, rows x N(N - 1) x layers, to
``GNN_MESSAGES``.  Float32 CUDA tensors with no gradient to record take
the hand-written kernel there (``ops/cuda_egnn.py``,
``csrc/egnn_messages.cu``; one launch for up to four layers) where it
takes the net's widths (``cuda_egnn.fits``: one coordinate a node, as the
couplings build it, and a hidden width that is a multiple of 4); the CPU,
other dtypes, training and other widths take ``egnn_messages_plain``, the
composition the JAX package writes.

``conv2d`` is the image and Lipschitz layers' convolution (NCHW by OIHW,
in the input's dtype); its forward, backward and double backward run
without cuDNN's TF32, which PyTorch allows by default for float32.

Numerics that follow JAX: ``jax.nn.gelu`` is the tanh approximation
(``F.gelu(approximate="tanh")``), ``jax.nn.silu`` is ``F.silu``, and
``jnp.round`` and ``torch.round`` both round half to even.  JAX's
transformer takes its attention scores in float32 even under x64
(nets.py:246-250); this port keeps the input's dtype there (ROADMAP R10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from flowstate_tpu_torch.ops import card, cuda_egnn
from flowstate_tpu_torch.utils.profiling import annotate

Tree = Dict[str, object]

GNN_MESSAGES = 0     # messages ``TorusEGNN.apply`` computed in this process


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             dtype, device) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, dtype=dtype, device=device)
            * (2.0 * bound) - bound)


def _linear_init(in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator],
                 dtype=torch.float32, device="cuda") -> Tree:
    """``nn.Linear``'s default: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform((in_dim, out_dim), bound, generator, dtype, device),
            "b": _uniform((out_dim,), bound, generator, dtype, device)}


def _final_init(in_dim: int, out_dim: int, init_identity: bool,
                identity_bias: float, generator: Optional[torch.Generator],
                dtype, device) -> Tree:
    """The output layer: w = 0 and b = ``identity_bias`` with
    ``init_identity`` (the reference wrapper's identity init), else
    ``nn.Linear``'s default."""
    if not init_identity:
        return _linear_init(in_dim, out_dim, generator, dtype, device)
    return {"w": torch.zeros((in_dim, out_dim), dtype=dtype, device=device),
            "b": torch.full((out_dim,), identity_bias, dtype=dtype,
                            device=device)}


def _linear(params: Tree, x: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w + b``.  With a leading net axis (``w`` (G, in, out)), ``x``
    is (G, ..., in) and net g's weights meet ``x[g]``.  With
    ``compute_dtype`` the operands and the output are in that dtype."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x, w, b = x.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
    if w.dim() == 2:
        return torch.matmul(x, w) + b
    g, out = w.shape[0], w.shape[-1]
    y = torch.matmul(x.reshape(g, -1, x.shape[-1]), w)
    return (y.reshape(*x.shape[:-1], out)
            + b.reshape(g, *([1] * (x.dim() - 2)), out))


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's float32 convolutions without TF32 for the block (PyTorch
    allows TF32 there by default); the previous setting comes back."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pairs(stride: int, padding: int):
    return [stride, stride], [padding, padding], [1, 1]


class _Conv(torch.autograd.Function):
    """``F.conv2d`` with cuDNN's TF32 off in each pass: cuDNN reads the
    flag when a pass runs, so the forward, the backward and the double
    backward (a power-series log-det differentiated by the loss) each set
    it.  Every convolution of the port takes this path; off the card and
    in float64 the flag changes nothing, so the float64 tests against JAX
    hold its backward and double backward too."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        with _no_tf32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = _ConvBackward.apply(g, x, w, *ctx.conv,
                                     tuple(ctx.needs_input_grad[:2]))
        return gx, gw, None, None


class _ConvBackward(torch.autograd.Function):
    """The convolution's input and weight gradients, and their own
    gradients (``aten::_convolution_double_backward``), without TF32."""

    @staticmethod
    def forward(ctx, g, x, w, stride: int, padding: int, mask):
        ctx.save_for_backward(g, x, w)
        ctx.conv = (stride, padding)
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, *_pairs(stride, padding), False, [0, 0], 1,
                [mask[0], mask[1], False])
        return gx, gw

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ggx, ggw):
        g, x, w = ctx.saved_tensors
        with _no_tf32():
            gg, gx, gw = torch.ops.aten._convolution_double_backward(
                ggx, ggw, None, g, w, x, *_pairs(*ctx.conv), False, [0, 0],
                1, list(ctx.needs_input_grad[:3]))
        return gg, gx, gw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW ``x`` by OIHW ``w`` in ``x``'s dtype, through ``_Conv``: on the
    card a float32 convolution runs without TF32, which rounds the operands
    to 10 bits, and a log q summed over an image's thousands of dimensions
    would then miss a float64 tolerance."""
    return _Conv.apply(x, w, stride, padding)


def _layer_norm(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Biased variance, ``eps`` inside the rsqrt, no affine; statistics in
    float32 at least (bf16's variance is too coarse), the output in
    ``x``'s dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return F.layer_norm(xf, (x.shape[-1],), eps=eps).to(x.dtype)


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name is None else getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class PeriodicFeaturesElementwise:
    """The whole input to ``[cos(s x), sin(s x)]``, doubling the width."""

    ndim: int
    scale: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.cos(self.scale * x),
                          torch.sin(self.scale * x)], dim=-1)


@dataclasses.dataclass(frozen=True)
class PeriodicFeaturesCat:
    """The dims ``ind`` to ``[sin(s x), cos(s x)]`` pairs, ahead of the
    untouched dims."""

    ndim: int
    ind: Tuple[int, ...]
    scale: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        rest = [i for i in range(self.ndim) if i not in set(self.ind)]
        per = x[..., list(self.ind)] * self.scale
        feats = torch.cat([torch.sin(per), torch.cos(per)], dim=-1)
        if rest:
            feats = torch.cat([feats, x[..., rest]], dim=-1)
        return feats


@dataclasses.dataclass(frozen=True)
class ConstScaleLayer:
    """Scales its input by a fixed factor."""

    scale: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def clamp_exp(x: torch.Tensor) -> torch.Tensor:
    """The nonlinearity ``min(exp(x), 1)``."""
    return torch.clamp(torch.exp(x), max=1.0)


ClampExp = clamp_exp  # the reference's class name


@dataclasses.dataclass(frozen=True)
class ResidualNet:
    """Pre-activation residual MLP: with ``use_norm`` a LayerNorm before
    each activation (the couplings build it so; the port's default, where
    JAX's is False), with the context GLU when ``context_features`` is
    set, in ``compute_dtype`` when given."""

    in_features: int
    out_features: int
    hidden_features: int
    num_blocks: int = 2
    preprocessing: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    context_features: Optional[int] = None
    use_norm: bool = True
    compute_dtype: Optional[str] = None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    identity_bias: float = 0.0, dtype=torch.float32,
                    device="cuda", init_identity: bool = True) -> Tree:
        """The JAX init's distributions, drawn from ``generator``: the
        second linear of each block U(-1e-3, 1e-3), the final layer w = 0
        and b = ``identity_bias`` with ``init_identity``; the other linears
        as ``nn.Linear``'s default."""
        h = self.hidden_features
        ctx = self.context_features
        kw = dict(dtype=dtype, device=device)
        params = {"initial": _linear_init(self.in_features + (ctx or 0), h,
                                          generator, **kw)}
        blocks = []
        for _ in range(self.num_blocks):
            l1 = _linear_init(h, h, generator, **kw)
            l2 = {"w": _uniform((h, h), 1e-3, generator, **kw),
                  "b": _uniform((h,), 1e-3, generator, **kw)}
            block = {"l1": l1, "l2": l2}
            if ctx:
                block["ctx"] = _linear_init(ctx, h, generator, **kw)
            blocks.append(block)
        params["blocks"] = blocks
        params["final"] = _final_init(h, self.out_features, init_identity,
                                      identity_bias, generator, **kw)
        return params

    def apply(self, params: Tree, x: torch.Tensor,
              context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The net on ``x``; a conditional net also takes ``context``,
        (B, ctx), or (G, B, ctx) beside a batch of G nets."""
        cd = _dtype(self.compute_dtype)
        out_dtype = x.dtype
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        if self.context_features:
            x = torch.cat([x, context], dim=-1)
        norm = _layer_norm if self.use_norm else (lambda r: r)
        t = _linear(params["initial"], x, cd)
        for blk in params["blocks"]:
            r = _linear(blk["l1"], torch.relu(norm(t)), cd)
            r = _linear(blk["l2"], torch.relu(norm(r)), cd)
            if self.context_features:
                r = r * torch.sigmoid(_linear(blk["ctx"], context, cd))
            t = t + r
        out = _linear(params["final"], t, cd)
        return out.to(out_dtype) if cd is not None else out


@dataclasses.dataclass(frozen=True)
class MLP:
    """A plain MLP over ``layers`` = (in, h1, ..., out); its parameters
    are a list of linears."""

    layers: Tuple[int, ...]
    activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu
    init_zeros: bool = False

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda") -> List[Tree]:
        params = [_linear_init(self.layers[i], self.layers[i + 1], generator,
                               dtype, device)
                  for i in range(len(self.layers) - 1)]
        if self.init_zeros:
            params[-1] = {k: torch.zeros_like(v)
                          for k, v in params[-1].items()}
        return params

    def apply(self, params: List[Tree], x: torch.Tensor) -> torch.Tensor:
        for p in params[:-1]:
            x = self.activation(_linear(p, x))
        return _linear(params[-1], x)


@dataclasses.dataclass(frozen=True)
class TransformerNet:
    """Self-attention parameter net: the (featurised) input vector as a
    sequence of D scalars, each embedded to ``embed_dim``, ``num_layers``
    pre-norm blocks of ``num_heads``-head self-attention and a 4x GELU
    feed-forward, then one linear from the flattened (D x E) sequence.
    No positional encoding, as in the reference."""

    in_features: int
    out_features: int
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    preprocessing: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    identity_bias: float = 0.0, dtype=torch.float32,
                    device="cuda", init_identity: bool = True) -> Tree:
        e = self.embed_dim
        kw = dict(dtype=dtype, device=device)
        params = {"embed": _linear_init(1, e, generator, **kw), "blocks": [
            {"qkv": _linear_init(e, 3 * e, generator, **kw),
             "proj": _linear_init(e, e, generator, **kw),
             "ff1": _linear_init(e, 4 * e, generator, **kw),
             "ff2": _linear_init(4 * e, e, generator, **kw)}
            for _ in range(self.num_layers)]}
        params["final"] = _final_init(self.in_features * e, self.out_features,
                                      init_identity, identity_bias,
                                      generator, **kw)
        return params

    def apply(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        """``x`` (..., D), or (G, B, D) beside a batch of G nets."""
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        lead, d = x.shape[:-1], x.shape[-1]
        e, h = self.embed_dim, self.num_heads
        c = e // h
        t = _linear(params["embed"], x.unsqueeze(-1))          # (..., D, E)
        for blk in params["blocks"]:
            qkv = _linear(blk["qkv"], _layer_norm(t))          # (..., D, 3E)
            # (..., H, D, C) per head
            q, k, v = (part.reshape(*lead, d, h, c).transpose(-3, -2)
                       for part in qkv.split(e, dim=-1))
            att = torch.softmax(torch.matmul(q, k.transpose(-2, -1))
                                / math.sqrt(c), dim=-1)        # (..., H, D, D)
            o = torch.matmul(att, v).transpose(-3, -2).reshape(*lead, d, e)
            t = t + _linear(blk["proj"], o)
            t = t + _linear(blk["ff2"], F.gelu(
                _linear(blk["ff1"], _layer_norm(t)), approximate="tanh"))
        return _linear(params["final"], t.reshape(*lead, d * e))


@dataclasses.dataclass(frozen=True)
class TorusEGNN:
    """Message passing between particle nodes on the 2 pi torus: nodes
    embedded from [cos, sin] of their coordinates, ``num_layers`` rounds of
    SiLU messages from the pair's features and their wrapped relative
    coordinates (no self-messages), a residual SiLU update, then a mean
    over nodes and one linear."""

    num_node: int        # input features, read as nodes of feat_dim coords
    out_dim: int
    feat_dim: int = 2
    hidden_dim: int = 64
    num_layers: int = 2
    preprocessing: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    @property
    def n_particles(self) -> int:
        return max(1, self.num_node // self.feat_dim)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    identity_bias: float = 0.0, dtype=torch.float32,
                    device="cuda", init_identity: bool = True) -> Tree:
        h, fd = self.hidden_dim, self.feat_dim
        kw = dict(dtype=dtype, device=device)
        params = {"embed": _linear_init(2 * fd, h, generator, **kw),
                  "layers": [{"msg": _linear_init(2 * h + 2 * fd, h,
                                                  generator, **kw),
                              "upd": _linear_init(2 * h, h, generator, **kw)}
                             for _ in range(self.num_layers)]}
        params["final"] = _final_init(h, self.out_dim, init_identity,
                                      identity_bias, generator, **kw)
        return params

    def apply(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        """``x`` (..., num_node) coordinates, or (G, B, num_node) beside a
        batch of G nets; the preprocessing maps them onto the 2 pi torus."""
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        lead = x.shape[:-1]
        n, fd = self.n_particles, self.feat_dim
        flat = x[..., :n * fd]
        coords = flat.reshape(*lead, n, fd)
        global GNN_MESSAGES
        h = _linear(params["embed"], torch.cat([torch.cos(coords),
                                                torch.sin(coords)], dim=-1))
        layers = params["layers"]
        with annotate("flow.gnn.messages"):
            if card.takes_kernel(h, flat, *cuda_egnn.layer_leaves(layers)) \
                    and cuda_egnn.fits(n, fd, h.shape[-1]):
                h = cuda_egnn.egnn_messages(flat.contiguous(), h, layers)
            else:
                h = egnn_messages_plain(coords, h, layers)
        GNN_MESSAGES += math.prod(lead) * n * (n - 1) * len(layers)
        return _linear(params["final"], torch.mean(h, dim=-2))


def egnn_messages_plain(coords: torch.Tensor, h: torch.Tensor,
                        layers: List[Tree]) -> torch.Tensor:
    """``TorusEGNN``'s message passing in plain PyTorch: the node states
    (..., N, H) after every layer, from the coordinates (..., N, fd) on the
    2 pi torus and the states after the embedding; the kernel's plain
    version (``ops/cuda_egnn.py``), which the CPU, float64 and training
    take."""
    n = h.shape[-2]
    rel = coords.unsqueeze(-2) - coords.unsqueeze(-3)    # (..., N, N, fd)
    rel = rel - 2 * math.pi * torch.round(rel / (2 * math.pi))
    rel_feat = torch.cat([torch.sin(rel), torch.cos(rel)], dim=-1)
    off_diagonal = 1.0 - torch.eye(n, dtype=h.dtype, device=h.device)
    for layer in layers:
        width = (*h.shape[:-1], n, h.shape[-1])
        m_in = torch.cat([h.unsqueeze(-2).expand(width),
                          h.unsqueeze(-3).expand(width), rel_feat], dim=-1)
        m = F.silu(_linear(layer["msg"], m_in))
        agg = torch.sum(m * off_diagonal.unsqueeze(-1), dim=-2)
        h = h + F.silu(_linear(layer["upd"], torch.cat([h, agg], dim=-1)))
    return h
