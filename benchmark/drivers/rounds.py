"""Algorithm 1's big-move rounds (Phase D), in a closed loop.

The entry is the program's ``experiments.algorithm1.run_testing``, after
``experiments.common.init_and_equilibrate``: a round is one launch of
the move kernel (K1) of ``big_move_interval`` moves for every chain, one
flow proposal per chain (``sample_and_log_prob``), its inverse
``log_prob`` at the current point, one launch of the pair-energy kernel
(K2) for the proposals' energies and the Metropolis-Hastings verdict.
``run_testing`` runs chunks of ``rounds_per_chunk`` rounds and brings
each chunk's accept flags and positions to the host, as a user's run
does; the next chunk starts from the last one's state.

The flow the rounds are given is the program's, wrapped by ``FlowSpy``:
it opens the benchmark's spans around the two flow calls when traced,
and keeps the flow's outputs of each chunk's last round for the check.

The check, on ``check.chunks`` of the window's chunks drawn from the seed,
at their last round:

* ``logq_gap``: the largest |log q| gap over every chain, of the
  proposals and of the current points, against the reference flow in
  float64 on the same weights;
* ``verdict_faults``: chains whose verdict the program took otherwise
  than the reference's ``log u < log A``, with the round's uniforms ``u``
  drawn again from the generator's state that ``FlowSpy`` kept after the
  proposal (``run_testing`` draws them next), over every chain whose
  reference log A lies more than ``VERDICT_MARGIN`` from log u; plus
  chains whose position after the round is not the proposal where the
  program accepted, or the current point where it rejected.  Infinite
  where fewer than half of the chains are judged;
* ``energy_gap``: the largest gap between the state's energy after the
  chunk and the reference energy of its positions, over every chain;
* ``k1_gap``: on ``check.k1_chains`` chains drawn from the seed, K1's
  positions before the big move against the reference's replay of the
  round's launch from the previous round's positions, over the chains
  that met no decision within rounding of a tie
  (``drivers/common.py::k1_gap``).

The control (``control="lower"``, run with float32 products on TF32
tensor cores) judges the program's flow so, and puts the reference in
bfloat16 in the program's place for K1's positions and the state's
energies.  ``control="bf16"`` builds the residual net with
``compute_dtype="bfloat16"``, the program's own lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import trace
from benchmark import weights as bench_weights
from benchmark.drivers import common
from benchmark.harness import span
from benchmark.reference import flow as ref_flow
from benchmark.reference import metropolis as ref_mh
from benchmark.reference.system import System

# a verdict is judged where the reference's log A lies further than this
# from log u: the program's log A carries its rounding of two log q and
# two energies, which the check holds under 0.04 and 0.05 (A1's limits;
# 2 x 0.04 + 2 x 0.05 = 0.18 at beta = 1)
VERDICT_MARGIN = 0.2
STATE_TOLERANCE = 1e-4


class FlowSpy:
    """The program's flow as ``run_testing`` uses it, with spans and the
    record of the outputs of every ``every``-th round."""

    def __init__(self, model, every: int):
        self.model = model
        self.every = every
        self.calls = 0
        self.traced = False
        self.recording = False
        self.last = None

    @property
    def dtype(self):
        return self.model.dtype

    def sample_and_log_prob(self, num_samples, generator=None):
        self.calls += 1
        with span(self.traced, "bench.flow.sample_and_log_prob"):
            x, logq = self.model.sample_and_log_prob(num_samples, generator)
        if self.recording and self.calls % self.every == 0:
            self.last = {"x_new": x, "logq_new": logq,
                         "rng": generator.get_state()}
        return x, logq

    def log_prob(self, x):
        with span(self.traced, "bench.flow.log_prob"):
            logq = self.model.log_prob(x)
        if self.recording and self.calls % self.every == 0:
            self.last.update(x_old=x, logq_old=logq)
        return logq


def load_weights(model, tree) -> None:
    """Copy the benchmark's tree into the flow's parameters, which hold the
    same tree (the program's documented layout), checking every leaf."""
    ours = model.layers[0].params.tree()

    def copy(dst, src):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"weights of shape {tuple(src.shape)} for a "
                             f"parameter of {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)

    if len(model.layers) != 1:
        raise ValueError("the flow is not one stack of K couplings")
    bench_weights.tree_map(copy, ours, tree)


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        from flowstate_tpu_torch.experiments import algorithm1
        from flowstate_tpu_torch.experiments.common import (
            build_system, init_and_equilibrate,
        )
        from flowstate_tpu_torch.flows import build_circular_flow

        self.run_testing = algorithm1.run_testing
        self.control = control
        self.notes = {"k1_tie_share": 0.0, "verdicts_judged": 0,
                      "verdicts": 0, "accepted": 0}
        self.device = torch.device(device)
        self.seed = seed
        self.traffic = traffic
        self.flow_cfg = config["flow"]
        self.rounds = traffic["rounds_per_chunk"]
        if self.rounds < 2:
            raise ValueError("the check needs 2 or more rounds a chunk")
        self.cfg = common.experiment_config(config, traffic, seed,
                                            big_move_attempts=self.rounds)
        self.sys = System.from_config(config["system"])
        self.spec = build_system(self.cfg)
        f = self.flow_cfg
        model = build_circular_flow(
            self.cfg.num_particles, 2, self.cfg.half_box, K=f["K"],
            hidden_units=f["hidden_units"], num_bins=f["num_bins"],
            num_blocks=f["n_blocks"], net_type=f["net_type"],
            device=self.device,
            compute_dtype="bfloat16" if control == "bf16" else None)
        self.weights = bench_weights.make(f, config["init"], self.cfg.dim,
                                          seed, self.device)
        load_weights(model, self.weights)
        heads = model.layers[0].layer.num_heads
        if f["net_type"] == "transformer" and heads != f["num_heads"]:
            raise ValueError(f"the program's flow has {heads} heads, the "
                             f"configuration {f['num_heads']}")
        self.spy = FlowSpy(model, self.rounds)
        self.state = init_and_equilibrate(self.cfg, self.spec, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 1)
        self.records = []
        self._chunk()                       # warm-up: the cell's one shape
        common.sync(self.device)

    def _chunk(self):
        calls = self.state.calls
        max_disp = self.state.max_disp
        self.state, acc, pos = self.run_testing(
            self.cfg, self.spec, self.state, self.spy, self.generator)
        return {"calls": calls, "max_disp": max_disp, "acc": acc[-1],
                "pos_before": pos[-2], "pos_after": pos[-1],
                "energy_after": self.state.energy, **(self.spy.last or {})}

    def window(self, seconds: float) -> dict:
        self.spy.recording = True
        clock = common.Clock()
        chunks = failed = 0
        while clock() < seconds:
            record = self._chunk()
            chunks += 1
            failed += int(not np.isfinite(record["pos_after"]).all())
            self.records.append(record)
        elapsed = clock()
        self.spy.recording = False
        rounds = chunks * self.rounds
        return {"big_moves_per_s": self.cfg.num_chains * rounds / elapsed,
                "attempted": chunks, "failed": failed, "seconds": elapsed,
                "units": rounds, "unit_s": elapsed / rounds}

    def traced(self) -> tuple:
        from flowstate_tpu_torch.mcmc import cuda_metropolis
        from flowstate_tpu_torch.ops import cuda_pair

        self.spy.traced = True
        k1, k2 = cuda_metropolis.LAUNCHES, cuda_pair.LAUNCHES
        _, tr = trace.profile(self._chunk, lambda name: span(True, name))
        self.spy.traced = False
        info = {"units": self.rounds, "chains": self.cfg.num_chains,
                "k1_launches": cuda_metropolis.LAUNCHES - k1,
                "k2_launches": cuda_pair.LAUNCHES - k2,
                "k1_records": len(tr.kernels("metropolis_moves")),
                "k2_records": len(tr.kernels("pair_"))}
        return info, tr

    def _logq(self, params, x) -> np.ndarray:
        """The reference's float64 log q of ``x``, in blocks of rows."""
        f, block = self.flow_cfg, self.traffic["check"]["block"]
        with torch.no_grad():
            return np.concatenate([ref_flow.log_prob(
                params, x[i:i + block].double(), self.cfg.half_box,
                f["net_type"], f["hidden_units"], f["num_bins"],
                f.get("num_heads")).cpu().numpy()
                for i in range(0, len(x), block)])

    def _uniforms(self, rng_state, chains: int) -> np.ndarray:
        """The round's verdict uniforms, drawn again as ``run_testing``
        drew them, from the generator's state after the proposal."""
        g = torch.Generator(device=self.device)
        g.set_state(rng_state)
        return torch.rand(chains, generator=g,
                          device=self.device).double().cpu().numpy()

    def check(self) -> dict:
        """The numbers compared (see the module's docstring)."""
        del self.spy.model, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        params = bench_weights.tree_map(lambda t: t.double(), self.weights)
        draw = common.rng(self.seed, 1)
        take = min(self.traffic["check"]["chunks"], len(self.records))
        chosen = sorted(draw.choice(len(self.records), take, replace=False))
        b = self.cfg.half_box
        n = self.cfg.num_particles
        lower = self.control == "lower"
        gaps = {"logq_gap": 0.0, "verdict_faults": 0, "energy_gap": 0.0,
                "k1_gap": 0.0}
        for i in chosen:
            rec = self.records[i]
            x_new, x_old = rec["x_new"].detach(), rec["x_old"].detach()
            lq_new, lq_old = self._logq(params, x_new), self._logq(params, x_old)
            gaps["logq_gap"] = max(
                gaps["logq_gap"],
                common.max_gap(rec["logq_new"].cpu().numpy(), lq_new),
                common.max_gap(rec["logq_old"].cpu().numpy(), lq_old))
            p_new = x_new.cpu().double().numpy().reshape(-1, n, 2) + b
            p_old = x_old.cpu().double().numpy().reshape(-1, n, 2) + b
            e_new, _ = common.energies(self.sys, p_new, self.device)
            e_old, _ = common.energies(self.sys, p_old, self.device)
            with np.errstate(invalid="ignore"):
                ratio = ref_mh.log_ratio(self.sys.beta, e_new, e_old,
                                         lq_new, lq_old)
            ratio = np.where(np.isnan(ratio), -np.inf, ratio)
            acc = np.asarray(rec["acc"], dtype=bool)
            u = self._uniforms(rec["rng"], len(acc))
            with np.errstate(divide="ignore"):
                log_u = np.log(u)
            judged = (u > 0) & (np.abs(ratio - log_u) > VERDICT_MARGIN)
            wrong = judged & ((ratio > log_u) != acc)
            expect = np.where(acc[:, None, None], p_new, p_old)
            moved = ref_mh.position_gap(rec["pos_after"], expect, self.sys.box)
            gaps["verdict_faults"] += int(wrong.sum()
                                          + (~(moved <= STATE_TOLERANCE)).sum())
            if judged.mean() < common.MIN_COMPARED:
                gaps["verdict_faults"] = float("inf")
            self.notes["verdicts_judged"] += int(judged.sum())
            self.notes["verdicts"] += len(acc)
            self.notes["accepted"] += int(acc.sum())
            e_ref, _ = common.energies(self.sys, rec["pos_after"], self.device)
            e_prog = (common.energies(self.sys, rec["pos_after"], self.device,
                                      dtype=common.LOWER)[0] if lower
                      else rec["energy_after"].cpu().numpy())
            gaps["energy_gap"] = max(gaps["energy_gap"],
                                     common.max_gap(e_prog, e_ref))
            sample = np.sort(draw.choice(len(acc), min(
                self.traffic["check"]["k1_chains"], len(acc)), replace=False))
            gap, ties = common.k1_gap(
                self.sys, self.seed, sample, rec["calls"] + self.rounds - 1,
                self.cfg.big_move_interval, rec["pos_before"][sample],
                p_old[sample], rec["max_disp"].cpu().numpy()[sample], lower)
            gaps["k1_gap"] = max(gaps["k1_gap"], gap)
            self.notes["k1_tie_share"] = max(self.notes["k1_tie_share"], ties)
        return gaps
