"""Production sampling with the move kernel (Phase A, Phase B and
MCMC-only), bypassing the flow.

The entry is the program's ``mcmc.cuda_metropolis.run_production_kernel``
after ``experiments.common.init_and_equilibrate``: each block is one
launch of the move kernel (K1) of ``moves_per_sample`` moves for every
chain, one launch of the pair-energy kernel (K2) that resyncs the
energies and virials, and one observable sample.  A chunk of
``samples_per_chunk`` samples comes to the host (positions, energies,
pressures), as Phase B brings its samples, and replaces the chunk before
last there: three host buffers, touched in the set-up, take the chunks in
turn (the window's last two stay for the check, the traced chunk takes
the third), so that nothing grows and no page is first touched in the
window.

The check, on the window's last two chunks, at a sample drawn from the
seed:

* ``k1_gap``: on ``check.k1_chains`` chains drawn from the seed, K1's
  positions after the block against the reference's replay of that
  launch from the previous sample's positions, over the chains that met
  no decision within rounding of a tie (``drivers/common.py::k1_gap``);
* ``energy_gap`` and ``virial_gap``: over every chain, the sample's
  energy (K2's, per particle times N) and its virial (from the pressure,
  ``rho / beta + W / 2V``) against the reference's of its positions, the
  virial's gap relative to max(1, |W|).

The control (``control="lower"``) puts the reference in bfloat16 in the
program's place: the replay for K1's positions, the energies and virials
for K2's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import trace
from benchmark.drivers import common
from benchmark.harness import span
from benchmark.reference.system import System


HOST_FIELDS = ("positions", "energy_per_particle", "pressure")


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        from flowstate_tpu_torch.experiments.common import (
            build_system, init_and_equilibrate,
        )
        from flowstate_tpu_torch.mcmc import cuda_metropolis

        self.run_production = cuda_metropolis.run_production_kernel
        self.device = torch.device(device)
        self.seed = seed
        self.control = control
        self.notes = {"k1_tie_share": 0.0}
        self.traffic = traffic
        self.samples = traffic["samples_per_chunk"]
        self.cfg = common.experiment_config(
            config, traffic, seed, sampling_frequency=traffic["moves_per_sample"])
        self.sys = System.from_config(config["system"])
        self.spec = build_system(self.cfg)
        self.state = init_and_equilibrate(self.cfg, self.spec, self.device)
        self.records = []
        self.buffers, self.turn = None, 0
        self._chunk()                       # warm-up: the cell's one shape
        common.sync(self.device)

    def _chunk(self) -> dict:
        calls, max_disp = self.state.calls, self.state.max_disp
        self.state, obs = self.run_production(
            self.spec, self.cfg.beta, self.state, self.samples,
            self.cfg.sampling_frequency)
        if self.buffers is None:
            self.buffers = [{f: torch.zeros(getattr(obs, f).shape,
                                            dtype=getattr(obs, f).dtype)
                             for f in HOST_FIELDS} for _ in range(3)]
        host = self.buffers[self.turn]
        self.turn = (self.turn + 1) % 3
        for f in HOST_FIELDS:
            host[f].copy_(getattr(obs, f))
        return {"calls": calls, "max_disp": max_disp,
                **{f: host[f].numpy() for f in HOST_FIELDS}}

    def window(self, seconds: float) -> dict:
        clock = common.Clock()
        chunks = failed = 0
        while clock() < seconds:
            record = self._chunk()
            chunks += 1
            failed += int(not np.isfinite(record["positions"][:, -1]).all())
            self.records = self.records[-1:] + [record]
        elapsed = clock()
        blocks = chunks * self.samples
        moves = self.cfg.num_chains * blocks * self.cfg.sampling_frequency
        return {"mc_moves_per_s": moves / elapsed, "attempted": chunks,
                "failed": failed, "seconds": elapsed, "units": blocks,
                "unit_s": elapsed / blocks}

    def traced(self) -> tuple:
        from flowstate_tpu_torch.mcmc import cuda_metropolis
        from flowstate_tpu_torch.ops import cuda_pair

        k1, k2 = cuda_metropolis.LAUNCHES, cuda_pair.LAUNCHES
        _, tr = trace.profile(self._chunk, lambda name: span(True, name))
        info = {"units": self.samples, "chains": self.cfg.num_chains,
                "k1_launches": cuda_metropolis.LAUNCHES - k1,
                "k2_launches": cuda_pair.LAUNCHES - k2,
                "k1_records": len(tr.kernels("metropolis_moves")),
                "k2_records": len(tr.kernels("pair_"))}
        return info, tr

    def check(self) -> dict:
        """The numbers compared (see the module's docstring)."""
        del self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        draw = common.rng(self.seed, 2)
        n, volume = self.cfg.num_particles, self.sys.box ** 2
        lower = self.control == "lower"
        gaps = {"k1_gap": 0.0, "energy_gap": 0.0, "virial_gap": 0.0}
        for rec in self.records:
            pos = rec["positions"]                     # (C, T, N, 2)
            i = int(draw.integers(1, pos.shape[1]))
            e_ref, w_ref = common.energies(self.sys, pos[:, i], self.device)
            e_prog = rec["energy_per_particle"][:, i].astype(np.float64) * n
            w_prog = ((rec["pressure"][:, i].astype(np.float64)
                       - n / volume / self.sys.beta) * 2.0 * volume)
            if lower:
                e_prog, w_prog = common.energies(self.sys, pos[:, i],
                                                 self.device,
                                                 dtype=common.LOWER)
            scale = np.maximum(1.0, np.abs(w_ref))
            gaps["energy_gap"] = max(gaps["energy_gap"],
                                     common.max_gap(e_prog, e_ref))
            gaps["virial_gap"] = max(gaps["virial_gap"], common.max_gap(
                w_prog / scale, w_ref / scale))
            sample = np.sort(draw.choice(pos.shape[0], min(
                self.traffic["check"]["k1_chains"], pos.shape[0]),
                replace=False))
            gap, ties = common.k1_gap(
                self.sys, self.seed, sample, rec["calls"] + i,
                self.cfg.sampling_frequency, pos[sample, i - 1],
                pos[sample, i], rec["max_disp"].cpu().numpy()[sample], lower)
            gaps["k1_gap"] = max(gaps["k1_gap"], gap)
            self.notes["k1_tie_share"] = max(self.notes["k1_tie_share"],
                                             ties)
        return gaps
