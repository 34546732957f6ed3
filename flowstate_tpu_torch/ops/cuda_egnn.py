"""The torus EGNN's message passing as a hand-written CUDA kernel.

``egnn_messages`` launches ``csrc/egnn_messages.cu``: the message-passing
layers of one ``flows/nets.py::TorusEGNN.apply`` call, from the relative
coordinates through the last layer's update, in one launch on the current
stream for every ``MAX_LAYERS`` layers.  It replaces no TPU kernel (XLA
fused the JAX package's jnp EGNN on the TPU); its plain version is
``flows/nets.py::egnn_messages_plain``, which CPU tensors, other dtypes,
calls that record a gradient (``ops/card.takes_kernel``) and nets the
kernel does not take (``fits``) take.  A launch is its checks, one
``torch.empty`` and the kernel; ``LAUNCHES`` counts launches.

The inputs: the coordinates after the net's preprocessing (..., N), one a
node, the node states after the embedding (..., N, H), and each layer's
``msg`` and ``upd`` linears, ``w`` (in, out) and ``b`` (out,), or with a
leading axis of G nets (the paired flow step's), where the inputs are (G,
B, ...) and net g's weights meet rows g.  All float32, contiguous, on one
card.  Any N and any H that is a multiple of 4 up to 1,024 whose row
fits in shared memory (``plan``): every width the port's configurations
build.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from flowstate_tpu_torch.ops import card

LAUNCHES = 0      # kernel launches in this process

# csrc/egnn_messages.cu's limits and launch constants
THREADS = 256     # a block
CHUNK = 8         # nodes whose sums a thread holds at once
MAX_HIDDEN = 1024  # and a multiple of 4
MAX_LAYERS = 4    # a launch; a call of more layers launches again
NODE_SLOTS = 128  # node states a block keeps at most
MAX_SHARED = 232448  # bytes of shared memory a block may opt in to, sm_90
_LINEARS = ("msg_w", "msg_b", "upd_w", "upd_b")


class _EgnnParams(ctypes.Structure):
    """Mirror of ``EgnnParams`` in ``csrc/egnn_messages.cu``."""

    _fields_ = [("rows", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in
        ("nets", "net_axis", "nodes", "hidden", "layers", "block_rows",
         "staged")] + [
        (name, ctypes.c_void_p * MAX_LAYERS) for name in _LINEARS]


def shared_bytes(n: int, hidden: int, rows: int, staged: bool) -> int:
    """Bytes of shared memory a block of ``rows`` rows takes, as
    ``shared_floats`` in the CUDA source counts them: the node states, W_b
    h, past ``CHUNK`` nodes the aggregates, the staged message weight, the
    pair features and the coordinates."""
    buffers = 3 if n > CHUNK else 2
    return 4 * (buffers * rows * (n * hidden + 4)
                + ((2 * hidden + 2) * hidden if staged else 0)
                + rows * n * n * 2 + rows * n)


def plan(n: int, hidden: int) -> Optional[Tuple[int, bool]]:
    """(rows a block, weights staged in shared memory) of a launch at N
    nodes and hidden width ``hidden``, or None where the kernel takes no
    such call: a width that is not a multiple of 4 up to ``MAX_HIDDEN``, or
    states of one row past the card's shared memory.  A block holds
    min(128 / N, 1024 / H) rows, the weights staged where they fit beside
    them, else read from L2, with fewer rows where the states alone would
    not fit."""
    if n < 1 or hidden % 4 or not 4 <= hidden <= MAX_HIDDEN:
        return None
    rows = max(1, min(NODE_SLOTS // n, THREADS * 4 // hidden))
    if shared_bytes(n, hidden, rows, True) <= MAX_SHARED:
        return rows, True
    while rows and shared_bytes(n, hidden, rows, False) > MAX_SHARED:
        rows -= 1
    return (rows, False) if rows else None


def fits(n: int, fd: int, hidden: int) -> bool:
    """Whether the kernel takes a ``TorusEGNN`` of N nodes of ``fd``
    coordinates and hidden width ``hidden``: one coordinate a node, as the
    couplings build it, and a ``plan``.  Other nets take the plain
    version on the card too."""
    return fd == 1 and plan(n, hidden) is not None


def layer_leaves(layers: Sequence[Dict]) -> List[torch.Tensor]:
    """Each layer's ``msg`` w, b and ``upd`` w, b, in that order."""
    return [lin[k] for layer in layers for lin in (layer["msg"],
                                                   layer["upd"])
            for k in ("w", "b")]


def pack(coords: torch.Tensor, h: torch.Tensor, layers: Sequence[Dict]
         ) -> _EgnnParams:
    """The kernel's parameters for one launch of up to ``MAX_LAYERS``
    layers; raises ValueError on what the kernel does not take."""
    if h.ndim < 2:
        raise ValueError(f"h must be (..., N, H), got {tuple(h.shape)}")
    n, hidden = h.shape[-2], h.shape[-1]
    lead = tuple(h.shape[:-2])
    launch = plan(n, hidden)
    if launch is None:
        raise ValueError(f"the kernel takes a hidden width that is a "
                         f"multiple of 4 up to {MAX_HIDDEN} and a row's "
                         f"states within {MAX_SHARED} bytes of shared "
                         f"memory, got N = {n}, H = {hidden}")
    if tuple(coords.shape) != lead + (n,):
        raise ValueError(f"coords must be {(*lead, n)}, one coordinate a "
                         f"node, got {tuple(coords.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"a launch takes 1 to {MAX_LAYERS} layers, got "
                         f"{len(layers)}")
    leaves = layer_leaves(layers)
    net_axis = leaves[0].ndim == 3
    nets = leaves[0].shape[0] if net_axis else 1
    if net_axis and (not lead or lead[0] != nets):
        raise ValueError(f"weights of {nets} nets for inputs of leading "
                         f"shape {lead}")
    pre = (nets,) if net_axis else ()
    shapes = [(2 * hidden + 2, hidden), (hidden,), (2 * hidden, hidden),
              (hidden,)]
    for i, t in enumerate(leaves):
        want = pre + shapes[i % 4]
        if tuple(t.shape) != want:
            raise ValueError(f"layer {i // 4} {_LINEARS[i % 4]} must be "
                             f"{want}, got {tuple(t.shape)}")
    for t in (coords, h, *leaves):
        if t.dtype != torch.float32:
            raise ValueError(f"the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    pointers = [t.data_ptr() for t in leaves]
    if any(ptr % 16 for ptr in (h.data_ptr(), *pointers)):  # read as float4
        raise ValueError("h and the weights must be 16-byte aligned")
    rows = math.prod(lead[1:] if net_axis else lead)
    params = _EgnnParams(rows=rows, nets=nets, net_axis=int(net_axis),
                         nodes=n, hidden=hidden, layers=len(layers),
                         block_rows=launch[0], staged=int(launch[1]))
    for k, name in enumerate(_LINEARS):
        getattr(params, name)[:len(layers)] = pointers[k::4]
    return params


def _library():
    from flowstate_tpu_torch.kernels import build

    return build.build().libs["egnn_messages"]


_ENTRY = None     # the bound entry point, set at the first launch


def _launch(params: _EgnnParams, tensors: Sequence[torch.Tensor],
            stream: int) -> None:
    """One launch of the kernel on ``stream``: ``tensors`` are (coords, h,
    the output, then the layers' weights, which ``params`` points to);
    raises if the launch returns a cudaError."""
    global LAUNCHES, _ENTRY
    if _ENTRY is None:
        fn = _library().flowstate_egnn_messages
        fn.argtypes = [ctypes.POINTER(_EgnnParams)] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _ENTRY = fn
    coords, h, out = tensors[:3]
    rc = _ENTRY(ctypes.byref(params), coords.data_ptr(), h.data_ptr(),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_messages launch failed: cudaError {rc}")
    LAUNCHES += 1


def _launch_on(device: torch.device, params: _EgnnParams,
               tensors: Sequence[torch.Tensor]) -> None:
    """``_launch`` on ``device``'s current stream."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    with torch.cuda.device(index):
        _launch(params, tensors, torch.cuda.current_stream(index).cuda_stream)


def egnn_messages(coords: torch.Tensor, h: torch.Tensor,
                  layers: Sequence[Dict]) -> torch.Tensor:
    """The node states after every layer of message passing, shaped like
    ``h`` (..., N, H), from the coordinates (..., N) on the 2 pi torus, the
    node states after the embedding and the layers' trees (``{"msg": {"w",
    "b"}, "upd": {"w", "b"}}``): one launch on the current stream for each
    ``MAX_LAYERS`` layers, the states between them in device memory."""
    out = h
    for first in range(0, len(layers), MAX_LAYERS):
        out = _launch_layers(coords, out, layers[first:first + MAX_LAYERS])
    return out


def _launch_layers(coords: torch.Tensor, h: torch.Tensor,
                   layers: Sequence[Dict]) -> torch.Tensor:
    params = pack(coords, h, layers)
    tensors = (coords, h, *layer_leaves(layers))
    if not all(card.on_card(t) for t in tensors):
        raise ValueError("egnn_messages takes CUDA tensors, got "
                         f"{h.device}; the plain message passing takes CPU "
                         "tensors")
    if any(t.device != h.device for t in tensors):
        raise ValueError("the EGNN's tensors lie on more than one device")
    out = torch.empty_like(h, memory_format=torch.contiguous_format)
    if params.rows == 0:
        return out
    _launch_on(h.device, params, (coords, h, out, *tensors[2:]))
    return out
