"""The spline's CUDA kernel (``flowstate_tpu_torch.ops.cuda_spline``,
``csrc/rq_spline.cu``) as far as the CPU reaches it.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
its plain version.  Here: the wrapper's checks and its parameters (the
ctypes struct against the CUDA source, field by field), the launch with
the library stubbed, and the path each call takes: with the launch replaced
by ``kernel_model`` (a model of the kernel's reading of its parameters:
the strides, the tail rule of each knot's slope, the scale, written apart
from ``_pad_derivatives``), one launch per spline call on the card with no
gradient to record, 60 a round of A1's flow, none where autograd records.
The plain path, which the CPU and training take, is held bit-equal to the
composition the couplings made before the kernel: the widths and heights
scaled, the unconditional parameters expanded, the log-det summed per row.
"""

import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from flowstate_tpu_torch.flows import (
    build_circular_flow, sum_except_batch, tree_map,
)
from flowstate_tpu_torch.flows.autoregressive import (
    MaskedPiecewiseRQSAutoregressive,
)
from flowstate_tpu_torch.ops import card, cuda_spline
from flowstate_tpu_torch.ops import splines as tsplines

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 2.5
SUM = tsplines.unconstrained_rational_quadratic_spline_sum
MIXED = ["circular", "linear", "circular"]


def _slots(tails, bins):
    return {"linear": bins - 1, "circular": bins}.get(
        tails if isinstance(tails, str) else None, bins + 1)


def _raw(b, d, bins, tails, seed, dtype=torch.float32):
    """(inputs, raw): inputs over [-1.3, 1.3] x the tail bound (some
    outside it) and a (B, D, 2 bins + slots) raw output of N(0, 2)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((b, d), generator=g, dtype=dtype) * 2 - 1) * 1.3 * BOUND
    raw = torch.randn((b, d, 2 * bins + _slots(tails, bins)), generator=g,
                      dtype=dtype) * 2.0
    return x, raw


def _split(raw, bins):
    return raw[..., :bins], raw[..., bins:2 * bins], raw[..., 2 * bins:]


def kernel_model(params, tensors):
    """What the kernel computes from its struct and tensors: the parameters
    read by the struct's strides, each knot's slope by the kernel's tail
    rule, the widths and heights times ``scale``, then the plain RQ map on
    the clamped inputs, identity outside the bound, the log-det summed."""
    x, w, h, d, flags, out, logdet = tensors
    p = params
    b, dims, k = p.batch, p.dims, p.bins

    def strided(t, sb, sd, n):
        return torch.as_strided(t, (b, dims, n), (sb, sd, 1),
                                t.storage_offset())

    xs = torch.as_strided(x, (b, dims), (p.x_sb, p.x_sd), x.storage_offset())
    uw = strided(w, p.w_sb, p.w_sd, k) * p.scale
    uh = strided(h, p.h_sb, p.h_sd, k) * p.scale
    ud = strided(d, p.d_sb, p.d_sd, p.slots)
    knot = torch.arange(k + 1)
    ends = (knot == 0) | (knot == k)
    if p.tails == cuda_spline.TAILS_LINEAR:
        end, slot = ends.expand(dims, k + 1), (knot - 1).expand(dims, k + 1)
    elif p.tails == cuda_spline.TAILS_CIRCULAR:
        end = torch.zeros((dims, k + 1), dtype=torch.bool)
        slot = torch.where(knot == k, 0, knot).expand(dims, k + 1)
    else:
        lin = (torch.zeros(dims, dtype=torch.bool) if flags is None
               else flags.bool())[:, None]
        end = lin & ends
        slot = torch.where(~lin & bool(p.tie) & (knot == k), 0, knot)
    slot = slot.clamp(0, max(p.slots - 1, 0))
    ident = torch.full((b, dims, k + 1), p.identity_derivative,
                       dtype=xs.dtype)
    picked = (torch.gather(ud, 2, slot.expand(b, dims, k + 1)) if p.slots
              else ident)
    slopes = torch.where(end, ident, picked)
    y, ld = tsplines.rational_quadratic_spline(
        torch.clamp(xs, -p.tail_bound, p.tail_bound), uw, uh, slopes,
        inverse=bool(p.inverse), left=-p.tail_bound, right=p.tail_bound,
        bottom=-p.tail_bound, top=p.tail_bound,
        min_bin_width=p.min_bin_width, min_bin_height=p.min_bin_height,
        min_derivative=p.min_derivative)
    inside = (xs >= -p.tail_bound) & (xs <= p.tail_bound)
    out.copy_(torch.where(inside, y, xs))
    logdet.copy_(torch.where(inside, ld, torch.zeros_like(ld)).sum(-1))


@pytest.fixture
def on_model(monkeypatch):
    """CPU tensors take the kernel's path, and a launch runs
    ``kernel_model`` and counts."""
    def launch_on(device, params, tensors):
        kernel_model(params, tensors)
        cuda_spline.LAUNCHES += 1

    monkeypatch.setattr(card, "on_card", lambda t: True)
    monkeypatch.setattr(cuda_spline, "_launch_on", launch_on)


# ----- the plain path ---------------------------------------------------


@pytest.mark.parametrize("tails", ["linear", "circular", MIXED,
                                  ["circular"] * 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_path_is_todays_composition_bit_for_bit(tails, inverse):
    """Raw parameters with the 1/sqrt(hidden) scale, stride-0
    unconditional ones, the per-row sum: equal to the bit to the spline
    the couplings called before, and its gradients too."""
    bins, scale = 8, 1.0 / 16.0
    x, raw = _raw(32, 3, bins, tails, seed=1)
    raw.requires_grad_(True)
    w, h, d = _split(raw, bins)
    out, ld = SUM(x, w, h, d, inverse=inverse, tails=tails,
                  tail_bound=BOUND, scale=scale)
    ref_out, ref_ld = tsplines.unconstrained_rational_quadratic_spline(
        x, w * scale, h * scale, d, inverse=inverse, tails=tails,
        tail_bound=BOUND)
    ref_ld = sum_except_batch(ref_ld)
    assert torch.equal(out, ref_out) and torch.equal(ld, ref_ld)
    g, = torch.autograd.grad((out.sum() + ld.sum()), raw)
    g_ref, = torch.autograd.grad((ref_out.sum() + ref_ld.sum()), raw)
    assert torch.equal(g, g_ref)
    # the unconditional form: (D, ...) parameters expanded over the batch
    u = [t[0].detach() for t in (w, h, d)]
    out, ld = SUM(x, *(t.expand(32, *t.shape) for t in u), inverse=inverse,
                  tails=tails, tail_bound=BOUND)
    ref_out, ref_ld = tsplines.unconstrained_rational_quadratic_spline(
        x, *(t.expand(32, *t.shape) for t in u), inverse=inverse,
        tails=tails, tail_bound=BOUND)
    assert torch.equal(out, ref_out)
    assert torch.equal(ld, sum_except_batch(ref_ld))


def test_cpu_calls_take_the_plain_path_and_launch_nothing():
    x, raw = _raw(16, 3, 8, MIXED, seed=2)
    before = cuda_spline.LAUNCHES
    with torch.no_grad():
        SUM(x, *_split(raw, 8), tails=MIXED, tail_bound=BOUND)
    assert cuda_spline.LAUNCHES == before


def test_float64_on_the_card_takes_the_plain_path(on_model):
    """The kernel is float32's: a float64 call on the card (a check's
    reference) is the plain composition and launches nothing."""
    x, raw = _raw(16, 3, 8, MIXED, seed=6, dtype=torch.float64)
    w, h, d = _split(raw, 8)
    before = cuda_spline.LAUNCHES
    with torch.no_grad():
        out, ld = SUM(x, w, h, d, tails=MIXED, tail_bound=BOUND, scale=0.5)
        ref_out, ref_ld = tsplines.unconstrained_rational_quadratic_spline(
            x, w * 0.5, h * 0.5, d, tails=MIXED, tail_bound=BOUND)
    assert cuda_spline.LAUNCHES == before
    assert torch.equal(out, ref_out) and torch.equal(ld, ref_ld.sum(-1))


# ----- the wrapper -------------------------------------------------------


def _kernel_args(**kw):
    args = dict(inverse=False, tails="linear", tail_bound=BOUND, scale=1.0,
                circular_tie=True, min_bin_width=1e-3, min_bin_height=1e-3,
                min_derivative=1e-3, eps=tsplines.SEARCH_EPS,
                identity_derivative=tsplines.IDENTITY_DERIVATIVE_CONSTANT)
    args.update(kw)
    return args


def test_kernel_wrapper_checks_its_input_and_refuses_cpu_tensors():
    x, raw = _raw(4, 3, 8, MIXED, seed=3)
    w, h, d = _split(raw, 8)
    call = cuda_spline.rq_spline_kernel
    args = _kernel_args(tails=MIXED)
    before = cuda_spline.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        call(x, w, h, d, **args)
    with pytest.raises(ValueError, match="takes float32, got torch.float16"):
        call(x.half(), w.half(), h.half(), d.half(), **args)
    with pytest.raises(ValueError, match="takes float32, got torch.float64"):
        call(x, w.double(), h, d, **args)
    with pytest.raises(ValueError, match="takes float32, got torch.float64"):
        call(x.double(), w.double(), h.double(), d.double(), **args)
    x33, raw33 = _raw(4, 3, 33, MIXED, seed=3)
    with pytest.raises(ValueError, match="1 to 32 bins"):
        call(x33, *_split(raw33, 33), **args)
    with pytest.raises(ValueError, match=r"inputs must be \(B, D\)"):
        call(x[..., None], w, h, d, **args)
    with pytest.raises(ValueError, match="widths must be"):
        call(x[:3], w, h, d, **args)
    with pytest.raises(ValueError, match="heights must be"):
        call(x, w, h[..., :7], d, **args)
    with pytest.raises(ValueError, match="derivatives must be"):
        call(x, w, h, d[..., :-1], **args)
    with pytest.raises(ValueError, match="derivatives must be"):
        call(x, w, h, d, **_kernel_args(tails="linear"))
    with pytest.raises(ValueError, match="2 tails for 3"):
        call(x, w, h, d, **_kernel_args(tails=MIXED[:2]))
    with pytest.raises(ValueError, match="last axis must be contiguous"):
        call(x, w.transpose(0, 2).contiguous().transpose(0, 2), h, d, **args)
    x1, raw1 = _raw(4, 3, 1, "linear", seed=3)
    with pytest.raises(ValueError, match="linear tails take 2"):
        call(x1, *_split(raw1, 1), **_kernel_args())
    with pytest.raises(ValueError, match="Minimal bin width"):
        call(x, w, h, d, **_kernel_args(tails=MIXED, min_bin_width=0.2))
    assert cuda_spline.LAUNCHES == before


def test_pack_reads_strides_and_tail_rules():
    x, raw = _raw(5, 3, 8, MIXED, seed=4)
    w, h, d = _split(raw, 8)
    p, linear = cuda_spline.pack(x, w, h, d, **_kernel_args(tails=MIXED))
    assert (p.batch, p.dims, p.bins, p.slots) == (5, 3, 8, 9)
    assert (p.w_sb, p.w_sd, p.d_sb, p.d_sd) == (75, 25, 75, 25)
    assert (p.tails, p.tie, linear) == (cuda_spline.TAILS_PER_DIM, 1,
                                        (False, True, False))
    u = w[0]
    p, linear = cuda_spline.pack(x, u.expand(5, 3, 8), h, d,
                                 **_kernel_args(tails=["circular"] * 3,
                                                circular_tie=False))
    assert (p.w_sb, p.w_sd, p.tie, linear) == (0, 25, 0, None)
    for tails, rule, slots in (("linear", cuda_spline.TAILS_LINEAR, 7),
                               ("circular", cuda_spline.TAILS_CIRCULAR, 8)):
        x, raw = _raw(5, 3, 8, tails, seed=4)
        p, _ = cuda_spline.pack(x, *_split(raw, 8), **_kernel_args(
            tails=tails))
        assert (p.tails, p.slots) == (rule, slots)


def test_kernel_launch_is_bound_once_and_counts_one_per_call(monkeypatch):
    """The launch with the library stubbed: the entry point's argtypes set
    at the first call only, one launch counted per call, None for a
    missing tensor, a cudaError raised and not counted."""
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
        flowstate_rq_spline = entry

    monkeypatch.setattr(cuda_spline, "_library", lambda: Library)
    monkeypatch.setattr(cuda_spline, "_ENTRY", None)
    x, raw = _raw(4, 3, 8, "linear", seed=5)
    w, h, d = _split(raw, 8)
    out, ld = torch.empty(4, 3), torch.empty(4)
    params, _ = cuda_spline.pack(x, w, h, d, **_kernel_args())
    tensors = (x, w, h, d, None, out, ld)
    before = cuda_spline.LAUNCHES
    for _ in range(3):
        cuda_spline._launch(params, tensors, 7)
    assert cuda_spline.LAUNCHES == before + 3
    assert len(bound) == 1 and len(bound[0]) == 9 and len(calls) == 3
    assert calls[0] == (x.data_ptr(), w.data_ptr(), h.data_ptr(),
                        d.data_ptr(), None, out.data_ptr(), ld.data_ptr(), 7)
    assert w.data_ptr() + 8 * 4 == h.data_ptr()      # slices, no copies
    entry.rc = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cuda_spline._launch(params, tensors, 7)
    assert cuda_spline.LAUNCHES == before + 3 and len(bound) == 1


def _c_struct_fields(source, struct):
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc", source)) as f:
        body = re.search(r"struct %s \{(.*?)\};" % struct, f.read(),
                         re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.match(r"(long long|int|double)\s+(.*);",
                                line).groups()
        fields += [(name.strip(), ctype) for name in names.split(",")]
    return fields


def test_params_struct_mirrors_the_cuda_source_field_by_field():
    names = {ctypes.c_longlong: "long long", ctypes.c_int: "int",
             ctypes.c_double: "double"}
    mine = [(name, names[t])
            for name, t in cuda_spline._SplineParams._fields_]
    assert mine == _c_struct_fields("rq_spline.cu", "SplineParams")


def test_tail_rule_constants_match_the_cuda_source():
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc",
                           "rq_spline.cu")) as f:
        src = f.read()
    for name, value in (("kTailsLinear", cuda_spline.TAILS_LINEAR),
                        ("kTailsCircular", cuda_spline.TAILS_CIRCULAR),
                        ("kTailsPerDim", cuda_spline.TAILS_PER_DIM),
                        ("kMaxBins", cuda_spline.MAX_BINS)):
        assert re.search(r"constexpr int %s = %d;" % (name, value), src), name


def test_cuda_spline_imports_without_nvcc_and_builds_nothing():
    code = ("import sys, flowstate_tpu_torch.ops.cuda_spline as m, "
            "flowstate_tpu_torch.flows; "
            "b = sys.modules.get('flowstate_tpu_torch.kernels.build'); "
            "ok = m.LAUNCHES == 0 and (b is None or b._LOADED is None); "
            "sys.exit(0 if ok else 1)")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": os.path.join(REPO, "no-such-cuda")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----- the path each call takes -------------------------------------------


@pytest.mark.parametrize("tails,tie", [
    ("linear", True), ("circular", True), (MIXED, True), (MIXED, False),
    (["circular"] * 3, False), (["linear"] * 3, True)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("bins", [1, 8, 32])
def test_one_launch_a_call_and_the_model_matches_the_plain_spline(
        on_model, tails, tie, inverse, bins):
    if tails == "linear":
        bins = max(bins, 2)     # the plain spline pads from a first slot
    x, raw = _raw(128, 3, bins, tails, seed=bins)
    w, h, d = _split(raw, bins)
    # inputs on knots and within 1e-6 of one (a few float32 ulps)
    knots, _ = tsplines._knots(w[0, 0] * 0.5, 1e-3, -BOUND, BOUND)
    x[:bins + 1, 0] = knots
    x[bins + 1:2 * bins + 2, 0] = knots + 1e-6
    w = w.clone()
    w[:, 0] = w[0, 0]
    before = cuda_spline.LAUNCHES
    with torch.no_grad():
        out, ld = SUM(x, w, h, d, inverse=inverse, tails=tails,
                      tail_bound=BOUND, scale=0.5, circular_tie=tie)
        ref_out, ref_ld = tsplines.unconstrained_rational_quadratic_spline(
            x, w * 0.5, h * 0.5, d, inverse=inverse, tails=tails,
            tail_bound=BOUND, circular_tie=tie)
    assert cuda_spline.LAUNCHES == before + 1
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-12)
    torch.testing.assert_close(ld, ref_ld.sum(-1), rtol=0, atol=1e-10)


def _a1_flow():
    torch.manual_seed(0)
    flow = build_circular_flow(3, 2, BOUND, K=15, hidden_units=16,
                               num_bins=8, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return flow


def test_a1_round_makes_60_launches_paired_or_not(on_model):
    flow = _a1_flow()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        x_old = flow.sample(64, g)
        before = cuda_spline.LAUNCHES
        x_new, lq_new = flow.sample_and_log_prob(64, g)
        lq_old = flow.log_prob(x_old)
        assert cuda_spline.LAUNCHES == before + 60
        before = cuda_spline.LAUNCHES
        paired = flow.sample_and_log_prob_with_old(64, x_old, g)
        assert cuda_spline.LAUNCHES == before + 60
    assert all(torch.isfinite(t).all() for t in (x_new, lq_new, lq_old,
                                                 *paired))


def test_grad_path_launches_nothing_and_the_kernel_path_matches_it(
        on_model):
    flow = _a1_flow()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        x = flow.sample(64, g)
        before = cuda_spline.LAUNCHES
        lq_kernel = flow.log_prob(x)
    assert cuda_spline.LAUNCHES == before + 30
    before = cuda_spline.LAUNCHES
    loss = flow.forward_kld(x)
    loss.backward()
    lq_plain = flow.log_prob(x)
    assert cuda_spline.LAUNCHES == before
    assert lq_plain.requires_grad
    torch.testing.assert_close(lq_kernel, lq_plain.detach(), rtol=0,
                               atol=1e-9)


def test_autoregressive_spline_goes_through_the_kernel_path(on_model):
    """The circular autoregressive proposal's layer: one launch for its
    forward, one per feature and one more for its sequential inverse."""
    layer = MaskedPiecewiseRQSAutoregressive(
        features=4, hidden_features=16, num_bins=8, tails="circular",
        tail_bound=BOUND)
    params = tree_map(lambda a: a + 0.1 * torch.randn_like(a),
                      layer.init_params(torch.Generator().manual_seed(3),
                                        dtype=torch.float32, device="cpu"))
    z = (torch.rand(16, 4) * 2 - 1) * BOUND
    before = cuda_spline.LAUNCHES
    with torch.no_grad():
        x, ld = layer.forward(params, z)
        z_back, ld_back = layer.inverse(params, x)
    assert cuda_spline.LAUNCHES == before + 1 + 4 + 1
    # float32: the round trip through the quadratic's root, a few ulps of
    # the bound (2.4e-7 at 2.5)
    torch.testing.assert_close(z_back, z, rtol=0, atol=1e-5)
    torch.testing.assert_close(ld_back, -ld, rtol=0, atol=1e-5)
