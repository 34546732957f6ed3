"""The port's torus EGNN conditioner (``flows/nets.py::TorusEGNN``) and its
gnn flow against the benchmark's plain reference
(``benchmark/reference/egnn.py``) in float64 on the CPU, on seeded random
weights: the net alone (with and without a net axis), the flow's log q of
given points and of its own samples; the message counter and the message
span; the benchmark's least count of the conditioner's products
(``benchmark/gnn_counts.py``) against PyTorch's counter on a factorised
plain evaluation; the benchmark's gnn weights against the program's
tree and the configuration's parameter count."""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import gnn_counts, gnn_weights
from benchmark.drivers.rounds import load_weights
from benchmark.reference import egnn as ref_egnn
from flowstate_tpu_torch.flows import build_circular_flow, nets
from flowstate_tpu_torch.flows.nets import ConstScaleLayer, TorusEGNN
from flowstate_tpu_torch.utils import profiling
from flowstate_tpu_torch.utils.roofs import matmul_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = torch.float64


def _config():
    with open(os.path.join(REPO, "benchmark", "configs", "n8_gnn.json")) as f:
        return json.load(f)


def _half_box(n: int) -> float:
    return math.sqrt(n / 0.03) / 2


def _net(n: int, hidden: int, layers: int, out: int, bound: float):
    return TorusEGNN(num_node=n, out_dim=out, feat_dim=1, hidden_dim=hidden,
                     num_layers=layers,
                     preprocessing=ConstScaleLayer(math.pi / bound))


def _trees(net, count: int, seed: int):
    """``count`` seeded trees of ``net``, and the same stacked on a
    leading axis (the reference's layout)."""
    g = torch.Generator().manual_seed(seed)
    trees = [net.init_params(g, dtype=DT, device="cpu", init_identity=False)
             for _ in range(count)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(t[k] for t in leaves)) for k in leaves[0]}
        if isinstance(leaves[0], list):
            return [stack(*(t[i] for t in leaves))
                    for i in range(len(leaves[0]))]
        return torch.stack(leaves)

    return trees, stack(*trees)


def _points(rows, n: int, bound: float, seed: int):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(*rows, n, generator=g, dtype=DT) * 2 - 1) * bound


def _flow(n: int, K: int, seed: int, hidden: int = 16, bins: int = 5):
    """The port's gnn flow in float64 with the benchmark's seeded tree."""
    f = dict(_config()["flow"], K=K, hidden_units=hidden, num_bins=bins)
    model = build_circular_flow(n, 2, _half_box(n), K=K, hidden_units=hidden,
                                num_bins=bins, num_blocks=f["n_blocks"],
                                net_type="gnn", dtype=DT, device="cpu")
    tree = gnn_weights.tree_map(
        lambda t: t.double(),
        gnn_weights.make(f, _config()["init"], 2 * n, seed, "cpu"))
    load_weights(model, tree)
    return model, tree, f


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("nets_axis", [None, 2])
def test_torus_egnn_matches_the_reference(n, layers, nets_axis):
    bound = _half_box(n)
    net = _net(n, 16, layers, 7, bound)
    trees, stacked = _trees(net, nets_axis or 1, seed=n + 10 * layers)
    if nets_axis is None:
        x = _points((33,), n, bound, seed=1)
        got = net.apply(trees[0], x)[None]
        xs = x[None]
    else:
        xs = _points((nets_axis, 33), n, bound, seed=2)
        got = net.apply(stacked, xs)
    for g in range(got.shape[0]):
        want = ref_egnn.gnn_net(stacked, g, xs[g], bound)
        assert torch.allclose(got[g], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,K", [(3, 2), (4, 3), (8, 2)])
def test_gnn_flow_log_q_matches_the_reference(n, K):
    model, tree, f = _flow(n, K, seed=n)
    bound = _half_box(n)
    g = torch.Generator().manual_seed(5)
    x = (torch.rand(40, 2 * n, generator=g, dtype=DT) * 2 - 1) * bound
    with torch.no_grad():
        program = model.log_prob(x)
        sample, logq = model.sample_and_log_prob(40, g)
    ref = ref_egnn.log_prob(tree, x, bound, f["hidden_units"], f["num_bins"])
    assert torch.isfinite(ref).all()
    assert torch.allclose(program, ref, rtol=0, atol=1e-10)
    ref_sample = ref_egnn.log_prob(tree, sample, bound, f["hidden_units"],
                                   f["num_bins"])
    assert torch.allclose(logq, ref_sample, rtol=0, atol=1e-10)


@pytest.mark.parametrize("where", ["net", "net_axis", "log_prob",
                                   "sample_and_log_prob"])
def test_the_message_counter(where):
    n, layers, K, rows = 5, 2, 3, 11
    per_row = n * (n - 1) * layers
    before = nets.GNN_MESSAGES
    with torch.no_grad():
        if where.startswith("net"):
            bound = _half_box(n)
            net = _net(n, 8, layers, 4, bound)
            trees, stacked = _trees(net, 2, seed=0)
            if where == "net":
                net.apply(trees[0], _points((rows,), n, bound, 0))
            else:
                net.apply(stacked, _points((2, rows), n, bound, 0))
                per_row *= 2
        else:
            model, _, _ = _flow(n, K, seed=1, hidden=8)
            if where == "log_prob":
                model.log_prob(_points((rows,), 2 * n, _half_box(n), 0))
            else:
                model.sample_and_log_prob(rows, torch.Generator().manual_seed(0))
            per_row *= K
    assert nets.GNN_MESSAGES - before == rows * per_row
    assert gnn_counts.messages({"K": K, "n_blocks": layers, "hidden_units": 8,
                                "num_bins": 5, "net_type": "gnn"},
                               2 * n, rows) == rows * n * (n - 1) * layers * K


def test_one_message_span_per_conditioner_call_inside_flow_net():
    K = 3
    model, _, _ = _flow(4, K, seed=2, hidden=8)
    x = _points((9,), 8, _half_box(4), 0)
    profiling.clear()
    with torch.no_grad(), profiling.recording():
        model.log_prob(x)
        model.sample_and_log_prob(9, torch.Generator().manual_seed(0))
    spans = profiling.spans()
    profiling.clear()
    by_id = {s.id: s for s in spans}
    messages = [s for s in spans if s.name == "flow.gnn.messages"]
    calls = [s for s in spans if s.name == "flow.net"]
    assert len(messages) == len(calls) == 2 * K
    assert all(by_id[s.parent].name == "flow.net" for s in messages)
    assert len({s.parent for s in messages}) == 2 * K


def _factorised(p, k, x_id, bound):
    """The conditioner with the message product split by its input's
    parts: ``W_a h`` and ``W_b h`` once per node, ``W_e e`` once per
    ordered pair of distinct nodes (``gnn_counts.py``'s least count)."""
    b, n = x_id.shape
    c = (math.pi / bound) * x_id
    h = torch.stack([torch.cos(c), torch.sin(c)], -1) @ p["embed"]["w"][k] \
        + p["embed"]["b"][k]
    hidden = h.shape[-1]
    i, j = torch.nonzero(~torch.eye(n, dtype=torch.bool), as_tuple=True)
    d = c[:, i] - c[:, j]
    r = d - 2 * math.pi * torch.round(d / (2 * math.pi))
    e = torch.stack([torch.sin(r), torch.cos(r)], -1)       # (B, n(n-1), 2)
    for layer in p["layers"]:
        w, bias = layer["msg"]["w"][k], layer["msg"]["b"][k]
        wa, wb, we = w[:hidden], w[hidden:2 * hidden], w[2 * hidden:]
        m = F.silu((h @ wa)[:, i] + (h @ wb)[:, j] + e @ we + bias)
        a = torch.zeros_like(h).index_add_(1, i, m)
        h = h + F.silu(torch.cat([h, a], -1) @ layer["upd"]["w"][k]
                       + layer["upd"]["b"][k])
    return h.mean(1) @ p["final"]["w"][k] + p["final"]["b"][k]


@pytest.mark.parametrize("n,hidden,bins", [(3, 16, 5), (8, 16, 4),
                                           (8, 64, 32)])
def test_the_least_count_is_the_factorised_evaluations(n, hidden, bins):
    f = {"K": 1, "hidden_units": hidden, "n_blocks": 2, "num_bins": bins,
         "net_type": "gnn"}
    out = n * (3 * bins + 1)
    bound = _half_box(n)
    net = _net(n, hidden, 2, out, bound)
    trees, stacked = _trees(net, 1, seed=n)
    x = _points((5,), n, bound, seed=3)
    least = matmul_flops(_factorised, stacked, 0, x, bound)
    assert least == 5 * gnn_counts.conditioner_flops(f, 2 * n)
    assert torch.allclose(_factorised(stacked, 0, x, bound),
                          ref_egnn.gnn_net(stacked, 0, x, bound),
                          rtol=0, atol=1e-12)
    with torch.no_grad():
        program = matmul_flops(net.apply, trees[0], x)
    assert least <= program
    if (n, hidden, bins) == (8, 64, 32):
        assert gnn_counts.conditioner_flops(f, 16) == 654336
        assert program == 5 * 2493440


def test_the_benchmarks_weights_load_into_the_program():
    config = _config()
    f = config["flow"]
    assert gnn_weights.count(f, 16) == config["parameters"] == 1270320
    model = build_circular_flow(8, 2, _half_box(8), K=f["K"],
                                hidden_units=f["hidden_units"],
                                num_bins=f["num_bins"],
                                num_blocks=f["n_blocks"], net_type="gnn",
                                device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 1270320
    tree = gnn_weights.make(f, config["init"], 16, 3, "cpu")
    load_weights(model, tree)
    ours = model.layers[0].params.tree()
    same = []
    gnn_weights.tree_map(lambda a, b: same.append(torch.equal(a, b)),
                         ours, tree)
    assert len(same) == len(gnn_weights.leaves(f, 16)) and all(same)
    shapes = {path: shape for path, shape, _ in gnn_weights.leaves(f, 16)}
    assert shapes[("net", "embed", "w")] == (15, 2, 64)
    assert shapes[("net", "layers", 1, "msg", "w")] == (15, 130, 64)
    assert shapes[("net", "layers", 0, "upd", "w")] == (15, 128, 64)
    assert shapes[("net", "final", "w")] == (15, 64, 776)
    again = gnn_weights.make(f, config["init"], 16, 3, "cpu")
    other = gnn_weights.make(f, config["init"], 16, 4, "cpu")
    assert torch.equal(tree["net"]["layers"][1]["msg"]["w"],
                       again["net"]["layers"][1]["msg"]["w"])
    assert not torch.equal(tree["net"]["final"]["w"], other["net"]["final"]["w"])
    with pytest.raises(ValueError, match="not the gnn"):
        gnn_weights.leaves(dict(f, net_type="residual"), 16)
