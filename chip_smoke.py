#!/usr/bin/env python3
"""Drive the PyTorch port (``flowstate_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA move kernel from ``flowstate_tpu_torch/csrc``,
holds it against its plain PyTorch version, checks its statistics and the
exact N=1 free energy, runs the MCMC-only experiment at the reference preset
through it, and times it.  Each phase prints one line with its name, PASS
and its numbers; any failure raises and the script exits non-zero.  The
line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero at once and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# Near-tie rule: an accept decision may differ between two versions only
# where |exp(-beta dE) - u| is below this (float rounding of dE).
NEAR_TIE = 1e-5
POS_ATOL = 1e-5
E_RTOL, E_ATOL = 1e-5, 1e-3


def phase(name: str, **numbers) -> None:
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{name}] PASS {fields}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current stream, by CUDA
    events over ``reps`` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reference_spec(n: int = 3):
    from flowstate_tpu_torch.ops import Box, SystemSpec

    return SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def phase_device() -> str:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = out.splitlines()[0]
    phase("1 device", cuda_devices=torch.cuda.device_count())
    print(card, flush=True)
    return card


def phase_build() -> float:
    from flowstate_tpu_torch.kernels import build

    res = build.build()
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    phase("2 build", seconds=f"{res.seconds:.2f}", library=res.path)
    return res.seconds


def compare_pathwise(spec, state, num_moves: int, seed: int, label: str,
                     beta: float = 1.0, fast_math: bool = False) -> float:
    """Kernel and plain version on the same injected tables; returns the
    largest absolute difference over positions and energies."""
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.metropolis import draw_tables

    c = state.positions.shape[0]
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    tables = draw_tables(spec, c, num_moves, g, DEVICE)
    mk = torch.empty((c, num_moves), device=DEVICE)
    mp = torch.empty_like(mk)
    out_k = cm.run_moves_kernel(spec, beta, state, num_moves, tables, mk,
                                fast_math)
    out_p = cm.run_moves_plain(spec, beta, state, num_moves, tables, mp)
    torch.cuda.synchronize()

    dk, dp = mk > 0, mp > 0
    # the kernel's decisions are exactly its margins' signs
    require(bool(((out_k.accepts - state.accepts)
                  == dk.sum(1).to(torch.int32)).all()),
            f"{label}: accept count != positive margins")
    differ = dk != dp
    split = differ.any(dim=1)
    first = differ.to(torch.int32).argmax(dim=1)
    rows = torch.nonzero(split).flatten()
    tie = mp[rows, first[rows]].abs()
    require(bool((tie < NEAR_TIE).all()),
            f"{label}: decisions differ away from a tie: margins "
            f"{tie[tie >= NEAR_TIE][:5].tolist()}")
    require(int(split.sum()) <= max(1, c // 100),
            f"{label}: {int(split.sum())} chains split at near ties")
    keep = ~split
    pos_err = float((out_k.positions - out_p.positions)[keep].abs().max())
    e_err = (out_k.energy - out_p.energy)[keep].abs()
    require(pos_err <= POS_ATOL, f"{label}: positions differ by {pos_err}")
    require(bool((e_err <= E_ATOL + E_RTOL * out_p.energy[keep].abs()).all()),
            f"{label}: energies differ by {float(e_err.max())}")
    require(bool(torch.isnan(out_k.virial).all()), f"{label}: virial not NaN")
    acc = float(dk.float().mean())
    print(f"  {label}: C={c} T={num_moves} acceptance={acc:.4f} "
          f"split_at_ties={int(split.sum())} pos_err={pos_err:.3g} "
          f"e_err={float(e_err.max()):.3g}", flush=True)
    return max(pos_err, float(e_err.max()))


def phase_pathwise() -> float:
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import init_alternating_wells, initialise_fcc
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.ops import SystemSpec

    def wells_state(n, c, seed):
        pos, _ = init_alternating_wells(c, n, 0.03)
        return init_chain_state(reference_spec(n),
                                torch.as_tensor(pos, device=DEVICE), seed, 0.65)

    errs = []
    spec3 = reference_spec(3)
    errs.append(compare_pathwise(spec3, wells_state(3, 100, 1), 150, 11,
                                 "N=3 main-path shape"))
    errs.append(compare_pathwise(spec3, wells_state(3, 1000, 2), 256, 12,
                                 "N=3 C=1000"))
    errs.append(compare_pathwise(spec3, wells_state(3, 1000, 2), 256, 12,
                                 "N=3 C=1000 fast_math", fast_math=True))
    errs.append(compare_pathwise(reference_spec(12), wells_state(12, 1000, 3),
                                 256, 13, "N=12"))
    pos, box = initialise_fcc(128, 0.3, 1.0)
    spec128 = SystemSpec.create(128, box, num_wells=0)
    s128 = init_chain_state(
        spec128, torch.as_tensor(np.broadcast_to(pos, (256, 128, 2)).copy(),
                                 device=DEVICE), 4, 0.3)
    errs.append(compare_pathwise(spec128, s128, 256, 14, "N=128 pure LJ"))
    err = max(errs)

    # Philox: the same state and seed reproduce bit for bit; the next
    # launch (calls + 1) and another seed draw fresh streams
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm

    s = wells_state(3, 1000, 5)
    a = cm.run_moves_kernel(spec3, 1.0, s, 256)
    b = cm.run_moves_kernel(spec3, 1.0, s, 256)
    nxt = cm.run_moves_kernel(spec3, 1.0, a.replace(positions=s.positions,
                                                    energy=s.energy), 256)
    other = cm.run_moves_kernel(spec3, 1.0, s.replace(seed=6), 256)
    require(torch.equal(a.positions, b.positions)
            and torch.equal(a.accepts, b.accepts), "Philox not reproducible")
    require(a.calls == s.calls + 1, "calls did not advance")
    require(not torch.equal(a.positions, nxt.positions)
            and not torch.equal(a.positions, other.positions),
            "Philox stream replayed across launches or seeds")
    phase("3 kernel vs plain, pathwise", max_abs_err=f"{err:.3g}",
          near_tie=NEAR_TIE, pos_atol=POS_ATOL, e_rtol=E_RTOL, e_atol=E_ATOL)
    return err


def phase_statistics(num_chains: int = 16384, eq_steps: int = 5000,
                     moves: int = 8192) -> None:
    import numpy as np
    import torch

    from flowstate_tpu_torch.analysis.wells import classify_particles
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.mcmc.metropolis import run_equilibration
    from flowstate_tpu_torch.mcmc.state import init_chain_state, resync_energy

    spec = reference_spec(3)
    pos, _ = init_alternating_wells(num_chains, 3, 0.03)
    s0 = init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 2024, 0.65)
    res = {}
    for name, mover in (("kernel", cm.run_moves_kernel),
                        ("plain", cm.run_moves_plain)):
        def move_fn(s, n, mover=mover):
            return mover(spec, 1.0, s, n)

        s = run_equilibration(spec, 1.0, s0, eq_steps, 5000, 0.5, move_fn)
        att0, acc0 = int(s.attempts.sum()), int(s.accepts.sum())
        s = move_fn(s, moves)
        exact = resync_energy(spec, s)
        e_pp = (exact.energy / 3).double()
        labels = classify_particles(s.positions.cpu().numpy(), 5.0, 1.2)
        res[name] = {
            "acceptance": (int(s.accepts.sum()) - acc0)
                          / (int(s.attempts.sum()) - att0),
            "drift": float((s.energy - exact.energy).abs().max()),
            "drift_mean": float((s.energy - exact.energy).abs().mean()),
            "e_mean": float(e_pp.mean()), "e_var": float(e_pp.var()),
            "occ": (float(np.mean(labels == 0)), float(np.mean(labels == 1))),
        }
    k, p = res["kernel"], res["plain"]
    sigma = np.sqrt((k["e_var"] + p["e_var"]) / num_chains)
    dist = abs(k["e_mean"] - p["e_mean"]) / sigma
    require(abs(k["acceptance"] - p["acceptance"]) < 0.02,
            f"acceptance kernel {k['acceptance']} vs plain {p['acceptance']}")
    require(k["drift"] < 1e-2, f"kernel energy drift {k['drift']}")
    require(dist < 4.0, f"energy/particle {k['e_mean']} vs {p['e_mean']}: "
                        f"{dist:.2f} sigma")
    phase("4 statistics", chains=num_chains, moves=moves,
          acceptance=f"{k['acceptance']:.4f}/{p['acceptance']:.4f}",
          drift_max_mean=f"{k['drift']:.3g}/{k['drift_mean']:.3g}",
          e_per_particle=f"{k['e_mean']:.5f}/{p['e_mean']:.5f}",
          sigma_dist=f"{dist:.2f}",
          occupancy_AB_kernel=f"({k['occ'][0]:.4f},{k['occ'][1]:.4f})",
          occupancy_AB_plain=f"({p['occ'][0]:.4f},{p['occ'][1]:.4f})")


def phase_exact_physics() -> None:
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.ops import Box, SystemSpec, double_well_potential

    spec = SystemSpec.create(1, Box.from_density(1, 0.01, 1.0), num_wells=2,
                             V0_list=(-2.0, -2.5), r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], -1),
                          dtype=torch.float32)
    v = double_well_potential(pts, lx, ly, V0_list=list(spec.V0_list),
                              r0=spec.r0, k=spec.k).numpy().reshape(g, g)
    w = np.exp(-v)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    in_b = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact = float(np.log(w[in_b].sum() / w[in_a].sum()))

    c = 256
    pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (c, 1, 1))
    pos0[c // 2:, :, 0] = 3 * lx / 4
    s = init_chain_state(spec, torch.as_tensor(pos0, device=DEVICE), 7, 1.5)
    s = cm.run_moves_kernel(spec, 1.0, s, 300)
    s, obs = cm.run_production_kernel(spec, 1.0, s, 600, 5)
    xy = obs.positions.reshape(-1, 2).cpu().numpy()
    sa = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    sb = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    sampled = float(np.log(sb.sum() / sa.sum()))
    require(abs(sampled - exact) < 0.12,
            f"N=1 delta F sampled {sampled} vs exact {exact}")
    phase("5 exact physics", delta_f_sampled=f"{sampled:.4f}",
          delta_f_exact=f"{exact:.4f}", bound=0.12)


def phase_main_path(total_steps: int = 10_000_000) -> dict:
    import numpy as np
    import torch

    from flowstate_tpu_torch.experiments import mcmc_only
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.utils.config import mcmc_only_config

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as out:
        config = mcmc_only_config(experiment_id="chip_smoke", output_dir=out)
        samples = total_steps // config.num_chains // config.sampling_frequency
        eq_blocks, eq_rest = divmod(config.equilibration_steps,
                                    config.adjusting_frequency)
        expected = eq_blocks + (1 if eq_rest else 0) + samples
        cm.LAUNCHES = 0
        result = mcmc_only.run(config, total_steps, device=DEVICE)
        torch.cuda.synchronize()
        launches = cm.LAUNCHES
        require(launches == expected,
                f"main path launched the kernel {launches} times, "
                f"schedule implies {expected}")
        d = result["directory"]
        needed = ["params.json", "experiment.log", "metrics.jsonl",
                  os.path.join(out, "evidence", "chip_smoke_data.json")]
        for i in range(config.num_chains):
            needed += [os.path.join("mc_runs", f"run_{i + 1:03d}", f)
                       for f in ("sampled_data.csv", "mc_run_configs.npy")]
        missing = [f for f in needed if not os.path.exists(os.path.join(d, f))]
        require(not missing, f"missing artifacts {missing[:5]}")
        rows = np.genfromtxt(os.path.join(d, "mc_runs", "run_001",
                                          "sampled_data.csv"),
                             delimiter=",", skip_header=1, usecols=(1, 3))
        require(rows.shape == (samples, 2) and np.isfinite(rows).all(),
                "sampled_data.csv energies/pressures not finite")
    acc = result["production_acceptance"]
    e_pp = result["energy_per_particle"]
    require(0.3 < acc < 0.7, f"production acceptance {acc}")
    require(abs(e_pp + 10.7) < 0.2, f"energy per particle {e_pp}")
    phase("6 main path", launches=launches, expected=expected,
          acceptance=f"{acc:.4f}", e_per_particle=f"{e_pp:.4f}",
          delta_f=f"{result['delta_f_mean']:.4f}+-{result['delta_f_sem']:.4f}",
          wall_s=f"{result['wall_s']:.2f}")
    return {"launches": launches}


def phase_timing(card: str, c: int = 16384, moves: int = 1000) -> dict:
    import numpy as np
    import torch

    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc import init_alternating_wells
    from flowstate_tpu_torch.mcmc.state import init_chain_state

    spec = reference_spec(3)

    def state(c):
        pos, _ = init_alternating_wells(c, 3, 0.03)
        return init_chain_state(spec, torch.as_tensor(pos, device=DEVICE), 5,
                                0.65)

    # the main path's launch: 100 chains x 150 moves
    s100 = state(100)
    ms = cuda_ms(lambda: cm.run_moves_kernel(spec, 1.0, s100, 150), 200)
    plain_ms = cuda_ms(lambda: cm.run_moves_plain(spec, 1.0, s100, 150), 3)

    # throughput: c chains x moves, 30 launches vs 2 for plain
    s = state(c)
    cm.run_moves_kernel(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        s = cm.run_moves_kernel(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    k_rate = 30 * c * moves / (time.perf_counter() - t0)
    s = state(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        s = cm.run_moves_plain(spec, 1.0, s, moves)
    torch.cuda.synchronize()
    p_rate = 2 * c * moves / (time.perf_counter() - t0)
    require(np.isfinite(k_rate) and np.isfinite(p_rate), "timing failed")
    phase("7 timing", card=f"'{card}'",
          main_path_launch_ms=f"{ms:.4f}", main_path_plain_ms=f"{plain_ms:.2f}",
          kernel_moves_per_s=f"{k_rate:.6g}", plain_moves_per_s=f"{p_rate:.6g}",
          chains=c, moves_per_launch=moves)
    return {"ms": ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import flowstate_tpu_torch  # noqa: F401  (fails outside the checkout)

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    err = phase_pathwise()
    phase_statistics()
    phase_exact_physics()
    main_path = phase_main_path()
    timing = phase_timing(card)
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "metropolis_moves",
        "route": "cuda",
        "source": "flowstate_tpu_torch/csrc/metropolis_moves.cu",
        "replaces": "flowstate_tpu/mcmc/pallas_metropolis.py:106",
        "launches": main_path["launches"],
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
