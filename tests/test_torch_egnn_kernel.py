"""The torus EGNN's message-passing kernel (``flowstate_tpu_torch.ops.
cuda_egnn``, ``csrc/egnn_messages.cu``) as far as the CPU reaches it.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
its plain version.  Here: the wrapper's checks and its parameters (the
ctypes struct against the CUDA source, field by field), the launch with
the library stubbed, and the path each call takes: with the launch
replaced by ``kernel_model`` (the kernel's factorised order, ``W_a h_i +
W_b h_j + W_e e_ij`` with the senders j != i skipped, read through the
struct), one launch per conditioner call (a further one for every four
layers past four) on the card with no gradient to record, inside the
``flow.gnn.messages`` span, none where autograd records; the launch plan
(rows a block, weights staged or read from L2) within the card's shared
memory.  The factorised order equals the concat form in float64, and the
plain path, which the CPU, training and the widths the kernel does not
take run, is the parent's composition bit for bit.
"""

import ctypes
import math
import os
import re
import subprocess
import sys
from time import time_ns
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from flowstate_tpu_torch.flows import build_circular_flow, nets, tree_map
from flowstate_tpu_torch.flows.nets import ConstScaleLayer, TorusEGNN
from flowstate_tpu_torch.ops import card, cuda_egnn, splines
from flowstate_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 5.0


def _net(n, hidden, layers, fd=1, out=7):
    return TorusEGNN(num_node=n * fd, out_dim=out, feat_dim=fd,
                     hidden_dim=hidden, num_layers=layers,
                     preprocessing=ConstScaleLayer(math.pi / BOUND))


def _tree(net, seed, dtype=torch.float32, nets_axis=None):
    """A seeded tree off the identity init; with ``nets_axis`` = G, G
    trees stacked on a leading axis."""
    g = torch.Generator().manual_seed(seed)
    trees = [net.init_params(g, dtype=dtype, device="cpu",
                             init_identity=False)
             for _ in range(nets_axis or 1)]
    if nets_axis is None:
        return trees[0]
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def _points(lead, width, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(*lead, width, generator=g, dtype=dtype) * 2 - 1) \
        * 1.2 * BOUND


def concat_form(coords, h, layers):
    """The parent's message passing, as ``TorusEGNN.apply`` wrote it before
    the kernel: the (..., N, N, 2H + 2fd) message inputs, one product, the
    diagonal mask, the sum over senders."""
    n = h.shape[-2]
    lead = h.shape[:-2]
    rel = coords.unsqueeze(-2) - coords.unsqueeze(-3)
    rel = rel - 2 * math.pi * torch.round(rel / (2 * math.pi))
    rel_feat = torch.cat([torch.sin(rel), torch.cos(rel)], dim=-1)
    off_diagonal = 1.0 - torch.eye(n, dtype=h.dtype, device=h.device)
    for layer in layers:
        width = (*lead, n, n, h.shape[-1])
        m_in = torch.cat([h.unsqueeze(-2).expand(width),
                          h.unsqueeze(-3).expand(width), rel_feat], dim=-1)
        m = F.silu(nets._linear(layer["msg"], m_in))
        agg = torch.sum(m * off_diagonal.unsqueeze(-1), dim=-2)
        h = h + F.silu(nets._linear(layer["upd"], torch.cat([h, agg], -1)))
    return h


def factorised(coords, h, layers, net_axis):
    """The kernel's order, written out: per row, node products ``W_a h_i
    + b_m`` and ``W_b h_j``, the pair features once, the messages
    ``(A_i + B_j) + W_e e_ij`` summed over j != i in order, the update;
    ``coords`` (R, N fd), ``h`` (R, N, H), row r meeting net r // (R / G)
    with a net axis."""
    rows, n, hidden = h.shape
    fd = coords.shape[-1] // n
    c = coords.reshape(rows, n, fd)
    d = c[:, :, None, :] - c[:, None, :, :]               # (R, i, j, fd)
    rel = d - 2 * math.pi * torch.round(d / (2 * math.pi))
    e = torch.cat([torch.sin(rel), torch.cos(rel)], dim=-1)
    nets_count = layers[0]["msg"]["w"].shape[0] if net_axis else 1
    per = rows // nets_count

    def weight(t, r):
        return t[r // per] if net_axis else t

    out = []
    for r in range(rows):
        hr = h[r]
        for layer in layers:
            wm, bm = weight(layer["msg"]["w"], r), weight(layer["msg"]["b"], r)
            wu, bu = weight(layer["upd"]["w"], r), weight(layer["upd"]["b"], r)
            a = hr @ wm[:hidden] + bm
            b = hr @ wm[hidden:2 * hidden]
            we = wm[2 * hidden:]
            agg = torch.zeros_like(hr)
            for i in range(n):
                for j in range(n):
                    if j != i:
                        agg[i] += F.silu(a[i] + b[j] + e[r, i, j] @ we)
            hr = hr + F.silu(torch.cat([hr, agg], -1) @ wu + bu)
        out.append(hr)
    return torch.stack(out)


def kernel_model(params, tensors):
    """What the kernel computes from its struct and tensors: the shapes and
    the net axis read from the struct, the weights in the order the
    struct's pointers name them, ``factorised`` on the flattened rows."""
    coords, h, out, *leaves = tensors
    p = params
    names = ("msg_w", "msg_b", "upd_w", "upd_b")
    for i, t in enumerate(leaves):
        assert getattr(p, names[i % 4])[i // 4] == t.data_ptr()
    layers = [{"msg": {"w": leaves[4 * l], "b": leaves[4 * l + 1]},
               "upd": {"w": leaves[4 * l + 2], "b": leaves[4 * l + 3]}}
              for l in range(p.layers)]
    rows = p.nets * p.rows
    assert p.layers <= cuda_egnn.MAX_LAYERS
    assert (p.block_rows, bool(p.staged)) == cuda_egnn.plan(p.nodes,
                                                            p.hidden)
    out.copy_(factorised(coords.reshape(rows, p.nodes),
                         h.reshape(rows, p.nodes, p.hidden), layers,
                         bool(p.net_axis)).reshape(out.shape))


@pytest.fixture
def on_model(monkeypatch):
    """CPU tensors take the EGNN kernel's path, and a launch runs
    ``kernel_model``, counts and records when it ran; the splines keep
    their plain path (their kernel's model is the spline tests')."""
    times = []

    def launch_on(device, params, tensors):
        times.append(time_ns())
        kernel_model(params, tensors)
        cuda_egnn.LAUNCHES += 1

    monkeypatch.setattr(card, "on_card", lambda t: True)
    monkeypatch.setattr(splines, "card", SimpleNamespace(
        takes_kernel=lambda *tensors: False))
    monkeypatch.setattr(cuda_egnn, "_launch_on", launch_on)
    return times


# ----- the algebra and the plain path --------------------------------------


@pytest.mark.parametrize("n,hidden,layers,fd", [
    (3, 16, 1, 1), (4, 8, 2, 1), (8, 16, 2, 1), (5, 12, 3, 2), (1, 4, 1, 1)])
@pytest.mark.parametrize("net_axis", [False, True])
def test_factorised_order_equals_the_concat_form_in_float64(
        n, hidden, layers, fd, net_axis):
    net = _net(n, hidden, layers, fd)
    tree = _tree(net, seed=n + hidden, dtype=torch.float64,
                 nets_axis=2 if net_axis else None)
    lead = (2, 6) if net_axis else (6,)
    x = net.preprocessing(_points(lead, n * fd, seed=1, dtype=torch.float64))
    # rel = 0 (equal coordinates) and rel = +-pi (the rint ties)
    x[..., 0, :fd] = x[..., 0, fd:2 * fd] if n > 1 else x[..., 0, :fd]
    x[..., 1, 0] = math.pi / 2
    if n > 1:
        x[..., 1, fd] = -math.pi / 2
    h = nets._linear(tree["embed"], torch.cat(
        [torch.cos(x.reshape(*lead, n, fd)),
         torch.sin(x.reshape(*lead, n, fd))], -1))
    want = concat_form(x.reshape(*lead, n, fd), h, tree["layers"])
    got = factorised(x.reshape(-1, n * fd), h.reshape(-1, n, hidden),
                     tree["layers"], net_axis).reshape(want.shape)
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("net_axis", [False, True])
def test_cpu_calls_are_the_parents_composition_and_launch_nothing(
        dtype, net_axis):
    net = _net(8, 16, 2)
    tree = _tree(net, seed=3, dtype=dtype, nets_axis=2 if net_axis else None)
    lead = (2, 9) if net_axis else (9,)
    x = _points(lead, 8, seed=4, dtype=dtype)
    before = cuda_egnn.LAUNCHES
    with torch.no_grad():
        got = net.apply(tree, x)
        c = net.preprocessing(x).reshape(*lead, 8, 1)
        h = nets._linear(tree["embed"], torch.cat([torch.cos(c),
                                                   torch.sin(c)], -1))
        want = nets._linear(tree["final"], torch.mean(
            concat_form(c, h, tree["layers"]), dim=-2))
    assert cuda_egnn.LAUNCHES == before
    assert torch.equal(got, want)


# ----- the wrapper -----------------------------------------------------------


def _call_args(n=8, hidden=16, layers=2, fd=1, net_axis=False, rows=5):
    net = _net(n, hidden, layers, fd)
    tree = _tree(net, seed=5, nets_axis=2 if net_axis else None)
    lead = (2, rows) if net_axis else (rows,)
    coords = _points(lead, n * fd, seed=6)
    h = torch.randn(*lead, n, hidden, generator=torch.Generator()
                    .manual_seed(7))
    return coords, h, tree["layers"]


def _refusals():
    """(name, arguments, message) of calls the wrapper refuses."""
    coords, h, layers = _call_args()

    def with_leaf(i, make):
        bad = [{k: dict(v) for k, v in layer.items()} for layer in layers]
        lin = ("msg", "upd")[i % 4 // 2]
        key = ("w", "b")[i % 2]
        bad[i // 4][lin][key] = make(bad[i // 4][lin][key])
        return bad

    many = _call_args(n=200)
    wide = _call_args(hidden=1028)
    odd = _call_args(hidden=18)
    return [
        ("cpu", (coords, h, layers), "CUDA"),
        ("float16", (coords.half(), h.half(), layers), "float32"),
        ("float64 weight", (coords, h, with_leaf(2, torch.Tensor.double)),
         "float32"),
        ("a row past shared memory", many, "within 232448 bytes"),
        ("hidden 1028", wide, "multiple of 4 up to 1024"),
        ("hidden 18", odd, "multiple of 4 up to 1024"),
        ("two coordinates a node", (torch.cat([coords] * 2, -1), h,
                                    layers), "coords must be"),
        ("three coordinates a node", (torch.cat([coords] * 3, -1), h,
                                      layers), "coords must be"),
        ("coordinates of other rows", (coords[:4], h, layers),
         "coords must be"),
        ("weights of 2 nets on one", (coords, h, _call_args(
            net_axis=True)[2]), "weights of 2 nets"),
        ("a weight's shape", (coords, h, with_leaf(4, lambda t: t[:-1])),
         "layer 1 msg_w must be"),
        ("strided h", (coords, h.transpose(-1, -2).contiguous()
                       .transpose(-1, -2), layers), "contiguous"),
        ("unaligned weight", (coords, h, with_leaf(
            3, lambda t: torch.empty(t.numel() + 1)[1:].view(t.shape)
            .copy_(t))), "16-byte aligned"),
    ]


@pytest.mark.parametrize("case", range(13))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    name, args, message = _refusals()[case]
    before = cuda_egnn.LAUNCHES
    with pytest.raises(ValueError, match=message):
        cuda_egnn.egnn_messages(*args)
    assert cuda_egnn.LAUNCHES == before, name


def test_pack_reads_the_shapes_and_the_net_axis():
    coords, h, layers = _call_args(n=5, hidden=12, layers=3,
                                   net_axis=True, rows=7)
    p = cuda_egnn.pack(coords, h, layers)
    assert (p.rows, p.nets, p.net_axis, p.nodes, p.hidden, p.layers,
            p.block_rows, p.staged) == (7, 2, 1, 5, 12, 3, 25, 1)
    assert p.upd_b[2] == layers[2]["upd"]["b"].data_ptr()
    assert p.msg_w[3] is None or p.msg_w[3] == 0
    coords, h, layers = _call_args(rows=3)
    p = cuda_egnn.pack(coords, h, layers)
    assert (p.rows, p.nets, p.net_axis) == (3, 1, 0)


def test_kernel_launch_is_bound_once_and_counts_one_per_call(monkeypatch):
    """The launch with the library stubbed: the entry point's argtypes set
    at the first call only, one launch counted per call, a cudaError
    raised and not counted."""
    calls, bound = [], []

    class Entry:
        restype = None
        rc = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                bound.append(value)
            object.__setattr__(self, name, value)

        def __call__(self, params, *pointers):
            calls.append(pointers)
            return self.rc

    entry = Entry()

    class Library:
        flowstate_egnn_messages = entry

    monkeypatch.setattr(cuda_egnn, "_library", lambda: Library)
    monkeypatch.setattr(cuda_egnn, "_ENTRY", None)
    coords, h, layers = _call_args()
    out = torch.empty_like(h)
    params = cuda_egnn.pack(coords, h, layers)
    tensors = (coords, h, out, *cuda_egnn.layer_leaves(layers))
    before = cuda_egnn.LAUNCHES
    for _ in range(3):
        cuda_egnn._launch(params, tensors, 7)
    assert cuda_egnn.LAUNCHES == before + 3
    assert len(bound) == 1 and len(bound[0]) == 5 and len(calls) == 3
    assert calls[0] == (coords.data_ptr(), h.data_ptr(), out.data_ptr(), 7)
    entry.rc = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cuda_egnn._launch(params, tensors, 7)
    assert cuda_egnn.LAUNCHES == before + 3 and len(bound) == 1


def _source():
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc",
                           "egnn_messages.cu")) as f:
        return f.read()


def test_params_struct_mirrors_the_cuda_source_field_by_field():
    body = re.search(r"struct EgnnParams \{(.*?)\};", _source(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            ctype, name, count = re.match(
                r"(long long|int|const float\*)\s+(\w+)(?:\[(\w+)\])?;",
                line).groups()
            fields.append((name, ctype, count))
    names = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    mine = []
    for name, t in cuda_egnn._EgnnParams._fields_:
        if t in names:
            mine.append((name, names[t], None))
        else:
            assert t._type_ is ctypes.c_void_p
            assert t._length_ == cuda_egnn.MAX_LAYERS
            mine.append((name, "const float*", "kMaxLayers"))
    assert mine == fields


def test_limits_match_the_cuda_source():
    src = _source()
    for name, value in (("kThreads", cuda_egnn.THREADS),
                        ("kChunk", cuda_egnn.CHUNK),
                        ("kMaxHidden", cuda_egnn.MAX_HIDDEN),
                        ("kMaxLayers", cuda_egnn.MAX_LAYERS),
                        ("kNodeSlots", cuda_egnn.NODE_SLOTS),
                        ("kMaxShared", cuda_egnn.MAX_SHARED)):
        assert re.search(r"constexpr int %s = %d;" % (name, value), src), name


def test_cuda_egnn_imports_without_nvcc_and_builds_nothing():
    code = ("import sys, flowstate_tpu_torch.ops.cuda_egnn as m, "
            "flowstate_tpu_torch.flows; "
            "b = sys.modules.get('flowstate_tpu_torch.kernels.build'); "
            "ok = m.LAUNCHES == 0 and (b is None or b._LOADED is None); "
            "sys.exit(0 if ok else 1)")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": os.path.join(REPO, "no-such-cuda")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----- the path each call takes ----------------------------------------------


@pytest.mark.parametrize("n,hidden,layers,net_axis", [
    (8, 16, 2, False), (8, 16, 2, True), (3, 8, 1, False), (4, 12, 2, True),
    (8, 256, 2, True), (16, 8, 2, False), (11, 12, 2, True),
    (3, 8, 5, True), (2, 4, 9, False)])
def test_one_launch_a_call_inside_the_message_span(on_model, n, hidden,
                                                   layers, net_axis):
    """A no-grad float32 call on the kernel's path: one launch for every
    four layers (one at the couplings' two), inside the call's one
    ``flow.gnn.messages`` span, the messages counted, the result the plain
    path's within float32's reordered sums; hidden 256 (``Config``'s
    default) and past eight nodes too."""
    launches = -(-layers // cuda_egnn.MAX_LAYERS)
    net = _net(n, hidden, layers)
    tree = _tree(net, seed=n, nets_axis=2 if net_axis else None)
    lead = (2, 5) if net_axis else (5,)
    x = _points(lead, n, seed=8)
    before, messages = cuda_egnn.LAUNCHES, nets.GNN_MESSAGES
    profiling.clear()
    with torch.no_grad(), profiling.recording():
        got = net.apply(tree, x)
    spans = [s for s in profiling.spans() if s.name == "flow.gnn.messages"]
    profiling.clear()
    assert cuda_egnn.LAUNCHES == before + launches
    assert len(on_model) == launches
    assert len(spans) == 1
    assert spans[0].start_ns <= on_model[0] <= on_model[-1] \
        <= spans[0].end_ns
    assert nets.GNN_MESSAGES - messages == 5 * (2 if net_axis else 1) \
        * n * (n - 1) * layers
    with torch.enable_grad():
        want = net.apply(tree, x.requires_grad_(True))
    assert cuda_egnn.LAUNCHES == before + launches
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grad_path_launches_nothing_and_is_the_plain_composition(on_model):
    net = _net(8, 16, 2)
    tree = _tree(net, seed=9)
    for leaf in cuda_egnn.layer_leaves(tree["layers"]):
        leaf.requires_grad_(True)
    x = _points((6,), 8, seed=10)
    before = cuda_egnn.LAUNCHES
    out = net.apply(tree, x)
    out.sum().backward()
    assert cuda_egnn.LAUNCHES == before
    assert tree["layers"][0]["msg"]["w"].grad is not None
    with torch.no_grad():
        c = net.preprocessing(x).reshape(6, 8, 1)
        h = nets._linear(tree["embed"], torch.cat([torch.cos(c),
                                                   torch.sin(c)], -1))
        want = nets._linear(tree["final"], torch.mean(
            concat_form(c, h, tree["layers"]), dim=-2))
    assert torch.equal(out.detach(), want)


@pytest.mark.parametrize("paired", [False, True])
def test_a_gnn_round_launches_once_a_conditioner_call(on_model, paired):
    """A big-move round of a K=3 gnn flow at N=4: the separate passes
    (``sample_and_log_prob`` and ``log_prob``, as ``run_testing`` runs
    them) launch 2K, the paired pass K, a training step none."""
    K = 3
    model = build_circular_flow(4, 2, BOUND, K=K, hidden_units=8,
                                num_bins=4, num_blocks=2, net_type="gnn",
                                device="cpu",
                                generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x_old = _points((7,), 8, seed=11) * 0.8
    before = cuda_egnn.LAUNCHES
    with torch.no_grad():
        if paired:
            model.sample_and_log_prob_with_old(7, x_old, g)
        else:
            model.sample_and_log_prob(7, g)
            model.log_prob(x_old)
    assert cuda_egnn.LAUNCHES - before == (K if paired else 2 * K)
    before = cuda_egnn.LAUNCHES
    loss = -model.log_prob(x_old).mean()
    loss.backward()
    assert cuda_egnn.LAUNCHES == before


@pytest.mark.parametrize("n,hidden,want", [
    (8, 64, (16, True)), (8, 128, (8, True)), (3, 16, (42, True)),
    (8, 256, (4, False)), (16, 256, (4, False)), (32, 256, (2, False)),
    (16, 1024, (1, False)), (8, 18, None), (8, 1028, None),
    (200, 64, None)])
def test_plan_fills_a_block_within_the_cards_shared_memory(n, hidden, want):
    """The cell's call stages its weights in 108 KB at 16 rows a block
    (two blocks an SM); wider layers read theirs from L2 and past-chunk
    nodes keep a third buffer, with fewer rows where the states would not
    fit; a row's threads never pass the block."""
    got = cuda_egnn.plan(n, hidden)
    assert got == want
    if got is not None:
        rows, staged = got
        assert rows * hidden // 4 <= cuda_egnn.THREADS
        assert cuda_egnn.shared_bytes(n, hidden, rows, staged) \
            <= cuda_egnn.MAX_SHARED
    assert cuda_egnn.fits(n, 1, hidden) == (want is not None)
    assert not cuda_egnn.fits(n, 2, hidden)
    if (n, hidden) == (8, 64):
        assert cuda_egnn.shared_bytes(n, hidden, 16, True) == 108032


@pytest.mark.parametrize("fd,hidden", [(2, 16), (1, 18)])
def test_widths_the_kernel_does_not_take_keep_the_plain_path(on_model, fd,
                                                             hidden):
    """A net the kernel does not take (two coordinates a node, a width
    that is no multiple of 4) on the card without autograd: the plain
    composition, bit for bit, and no launch."""
    net = _net(4, hidden, 2, fd)
    tree = _tree(net, seed=12)
    x = _points((6,), 4 * fd, seed=13)
    before = cuda_egnn.LAUNCHES
    with torch.no_grad():
        got = net.apply(tree, x)
        c = net.preprocessing(x).reshape(6, 4, fd)
        h = nets._linear(tree["embed"], torch.cat([torch.cos(c),
                                                   torch.sin(c)], -1))
        want = nets._linear(tree["final"], torch.mean(
            concat_form(c, h, tree["layers"]), dim=-2))
    assert cuda_egnn.LAUNCHES == before
    assert torch.equal(got, want)
