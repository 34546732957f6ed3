"""Hybrid Algorithm 2: interleave MCMC production, flow retraining, big moves.

Port of ``flowstate_tpu/experiments/algorithm2.py``:

  init and equilibration (the move kernel K1; the pair-energy kernel K2
  for the initial energies), then a small initial train set (skipped on
  resume); the flow with a ``DoubleWellLJ`` energy target and its initial
  training with the mixed loss ``alpha * forward_kld + (1 - alpha) *
  reverse_kld``; then ``num_training_cycles`` cycles of
      production through ``run_production_kernel`` (K1, a K2 resync per
      sample), the sliding-window or cumulative train set, a fresh Adam
      retrain, metrics every ``checkpoint_interval`` cycles, a checkpoint
      and an evaluation of the flow every twice that, and one flow big
      move per chain (K2 for the proposals' energies);
  and the final analysis: ``production_positions.npy`` (C, T, N, 2), ΔF
  per chain over the last ``num_samples_for_free_energy`` samples, and
  the acceptance against the training samples seen.

``fused=True`` runs the cycles in chunks of ``2 * checkpoint_interval``
through ``training/cycles.py``, which keep their results on the device
until the chunk ends; chunks never straddle ``freeze_after``, after which
the flow is no longer retrained.

Where it differs from the JAX driver:

* each cycle's generators come from ``(master_seed + 4, cycle)``
  (training) and ``(master_seed + 3, cycle)`` (big move), so the host loop
  and the fused runner agree bit for bit and a resumed run draws what an
  uninterrupted one would (JAX folds its move key once by the start
  cycle);
* the checkpoint holds the train set, so a resumed cumulative run trains
  on what it had (ROADMAP R7: JAX restarts it from zeros), and the host
  loop writes it at the end of its cycle, after the big move (ROADMAP
  R8: JAX writes it before, and a resumed run skips that cycle's move).

With ``blocked_k > 0`` (the JAX driver's :57-63, 101-140, 283, 296-312)
the flow is the blocked moves' conditional flow (``mcmc/blocked.py``,
depth ``blocked_K``, no energy target), every (re)training is
``train_blocked``, a cycle's big move is ``max(1, N // blocked_k)``
blocked moves drawn from the cycle's move generator, and no flow samples
are evaluated.  As in JAX it runs in the host loop only (``fused=True``
raises) and with the pure forward-KLD loss (``alpha < 1`` raises).

    python -m flowstate_tpu_torch.experiments.algorithm2 --experiment_id X \\
        [--resume] [--fused] [--freeze_after 500] --device cuda
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_acceptance_rate, plot_avg_free_energy, plot_frequency_heatmap,
    plot_loss, plot_pair_correlation, plot_well_statistics,
)
from flowstate_tpu_torch.analysis.rdf import calculate_pair_correlation
from flowstate_tpu_torch.analysis.wells import calculate_well_statistics
from flowstate_tpu_torch.experiments.common import (
    _thin, build_blocked_flow, build_system, init_and_equilibrate,
    log_blocked_depth, plot_wells, sector_counts, setup_experiment,
    write_evidence,
)
from flowstate_tpu_torch.flows import (
    DoubleWellLJ, build_circular_flow, params_from_jax,
)
from flowstate_tpu_torch.mcmc.blocked import blocked_big_moves
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_production_kernel
from flowstate_tpu_torch.mcmc.hybrid import to_centered
from flowstate_tpu_torch.training import (
    sliding_window_update, train, train_blocked,
)
from flowstate_tpu_torch.training.cycles import (
    MOVE_SEED_OFFSET, TRAIN_SEED_OFFSET, big_move, check_fused,
    cycle_generator, make_fused_cycles, train_config,
)
from flowstate_tpu_torch.utils.checkpoint import (
    chain_state_from_tree, experiment_tree, latest_checkpoint,
    restore_checkpoint, save_checkpoint,
)
from flowstate_tpu_torch.utils.config import ExperimentConfig, algorithm2_config

EVAL_SEED_OFFSET = 17


def centered_rows(positions: torch.Tensor, half_box: float) -> np.ndarray:
    """(..., N, 2) box-frame configurations as (M, N*2) float32 host rows
    in the flow's centred frame."""
    n = positions.shape[-2]
    return to_centered(positions.reshape(-1, n, 2), half_box).cpu().numpy()


def run(config: ExperimentConfig, resume: bool = False, fused: bool = False,
        freeze_after: Optional[int] = None, device="cuda") -> Dict:
    """Run Algorithm 2 on ``device``.  The results hold, beside the JAX
    driver's, the acceptance and loss histories, the wall seconds of each
    phase (``phase_s``), the cycle it started at, and the final ``state``
    and ``model``."""
    blocked = config.blocked_k > 0
    if fused:
        check_fused(config)
    if blocked and config.alpha < 1.0:
        raise ValueError("the mixed (reverse-KLD) loss has no conditional "
                         "form; blocked_k requires alpha=1.0")
    device = torch.device(device)
    phase_s = dict.fromkeys(("equilibration", "initial", "production",
                             "training", "big_move", "evaluation",
                             "fused_cycles", "analysis"), 0.0)
    t0 = time.perf_counter()
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    figures = [plot_wells(config, spec, directory)]
    c, n_part, half_box = (config.num_chains, config.num_particles,
                           config.half_box)

    state = init_and_equilibrate(config, spec, device, logger)
    metrics.log("equilibrated", chains=c)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phase_s["equilibration"] = time.perf_counter() - t0

    t = time.perf_counter()
    ckpt_dir = os.path.join(directory, "checkpoints")
    restored = latest_checkpoint(ckpt_dir) if resume else None
    if restored is not None:
        logger.info("resuming from checkpoint %s (cycle %d)", restored[1],
                    restored[0])
        tree, _ = restore_checkpoint(restored[1])
        # the saved train set: a resumed cumulative run trains on it (R7)
        train_set = tree["train_set"].numpy()
    else:
        samples_per_chain = max(1, config.initial_training_num_samples // c)
        state, obs = run_production_kernel(spec, config.beta, state,
                                           samples_per_chain,
                                           config.sampling_frequency)
        train_set = centered_rows(obs.positions, half_box)
    logger.info("initial train set: %d samples", len(train_set))

    init_generator = torch.Generator(device=device).manual_seed(
        config.master_seed + 1)
    context_fn = None
    if blocked:
        model, context_fn = build_blocked_flow(config, init_generator,
                                               device)
        log_blocked_depth(config, logger)
    else:
        target = DoubleWellLJ(dim=config.dim, n_particles=n_part,
                              temperature=config.temperature, bound=half_box,
                              V0_list=tuple(config.V0_list[:2]),
                              r0=config.r0, k=config.k_val)
        model = build_circular_flow(
            n_part, config.num_dim, half_box, K=config.K,
            hidden_units=config.hidden_units, num_bins=config.num_bins,
            num_blocks=config.n_blocks, net_type=config.net_type,
            target=target, generator=init_generator, device=device)
    train_cfg = train_config(config)

    def retrain(rows: np.ndarray, generator: torch.Generator) -> list:
        """One (re)training pass with a fresh Adam on centred rows."""
        rows = torch.as_tensor(rows, device=device)
        if blocked:
            configs = rows.reshape(-1, n_part, 2) + half_box
            return train_blocked(model, configs, config.blocked_k, half_box,
                                 train_cfg, generator,
                                 context_fn=context_fn)[2]
        return train(model, rows, train_cfg, generator)[3]

    start_cycle = 0
    if restored is not None:
        start_cycle = restored[0]
        params_from_jax(tree["flow"], model)
        state = chain_state_from_tree(tree["chains"], device)
        loss_per_cycle: list = []
    else:
        loss_per_cycle = list(retrain(train_set, torch.Generator(
            device=device).manual_seed(config.master_seed + 2)))
    phase_s["initial"] = time.perf_counter() - t

    p_acc_history = [0.0]
    training_samples_history = [len(train_set)]
    big_move_accepts = 0
    big_move_attempts = 0
    production_configs = [[] for _ in range(c)]   # per-chain (T, N, 2)
    new_samples_per_chain = max(1, config.update_num_samples // c)

    def save(cycle_done: int) -> None:
        save_checkpoint(ckpt_dir, cycle_done,
                        experiment_tree(model, state, train_set),
                        metadata={"cycle": cycle_done,
                                  "train_set_size": len(train_set)})

    def evaluate(cycle_done: int) -> None:
        """The flow's samples: heatmap and pair correlation (none for the
        conditional flow, which has no context-free sampler)."""
        if blocked:
            return
        with torch.no_grad():
            ev = model.sample(
                min(config.num_samples_for_analysis, 50000),
                cycle_generator(device, config.master_seed + EVAL_SEED_OFFSET,
                                cycle_done))
        ev = ev.cpu().numpy().reshape(-1, n_part, 2)
        figures.append(plot_frequency_heatmap(
            ev, directory, half_box,
            base_filename=f"heatmap_cycle_{cycle_done}"))
        r_vals, g_r = calculate_pair_correlation(ev[:5000], n_part, half_box)
        figures.append(plot_pair_correlation(
            r_vals, g_r, directory, base_filename=f"rdf_cycle_{cycle_done}"))

    total = config.num_training_cycles
    cycle = start_cycle
    while fused and cycle < total:
        t = time.perf_counter()
        n = min(2 * config.checkpoint_interval, total - cycle)
        # finite adaptation: chunks never straddle the freeze boundary
        do_train = freeze_after is None or cycle < freeze_after
        if do_train and freeze_after is not None:
            n = min(n, freeze_after - cycle)
        state, out = make_fused_cycles(model, spec, config, n,
                                       train=do_train)(state, cycle)
        losses = out["loss"].cpu().numpy()                 # (n, epochs)
        accepts = out["accepts"].cpu().numpy()             # (n,)
        pos = out["positions"].cpu().numpy()               # (n, C, T, N, 2)
        for j in range(n):
            if do_train:
                loss_per_cycle.extend(losses[j].tolist())
            big_move_attempts += c
            big_move_accepts += int(accepts[j])
            p_acc_history.append(big_move_accepts / big_move_attempts)
            training_samples_history.append(
                len(train_set) if cycle + j == 0 else
                config.update_num_samples)
        for i in range(c):
            production_configs[i].append(pos[:, i].reshape(-1, n_part, 2))
        if do_train:   # the last cycle's window, for the checkpoint
            train_set = centered_rows(out["positions"][-1], half_box)
        cycle += n
        phase_s["fused_cycles"] += time.perf_counter() - t
        t = time.perf_counter()
        figures.append(plot_loss(loss_per_cycle, directory,
                                 base_filename="loss_plot"))
        metrics.log("cycle", cycle=cycle,
                    loss=float(losses[-1][-1]) if do_train else None,
                    frozen=not do_train,
                    train_set=config.update_num_samples,
                    p_acc=p_acc_history[-1])
        save(cycle)
        evaluate(cycle)
        phase_s["evaluation"] += time.perf_counter() - t

    for cycle in range(cycle, total):      # the host loop (none if fused)
        # 1) production
        t = time.perf_counter()
        state, obs = run_production_kernel(spec, config.beta, state,
                                           new_samples_per_chain,
                                           config.sampling_frequency)
        new_mc = obs.positions.cpu().numpy()               # (C, T, N, 2)
        for i in range(c):
            production_configs[i].append(new_mc[i])
        new_nf = centered_rows(obs.positions, half_box)
        t1 = time.perf_counter()
        phase_s["production"] += t1 - t

        if freeze_after is None or cycle < freeze_after:
            # 2) the train-set policy, 3) a fresh optimizer and retrain
            train_set = sliding_window_update(
                train_set, new_nf,
                cumulative=config.cumulative_training_samples)
            loss_epoch = retrain(train_set, cycle_generator(
                device, config.master_seed + TRAIN_SEED_OFFSET, cycle))
            loss_per_cycle.extend(loss_epoch)
        else:  # finite adaptation: the flow frozen, the kernel now fixed
            loss_epoch = []
        t2 = time.perf_counter()
        phase_s["training"] += t2 - t1

        # 4) periodic metrics
        if (cycle + 1) % config.checkpoint_interval == 0:
            figures.append(plot_loss(loss_per_cycle, directory,
                                     base_filename="loss_plot"))
            metrics.log("cycle", cycle=cycle + 1,
                        loss=loss_epoch[-1] if loss_epoch else None,
                        train_set=len(train_set), p_acc=p_acc_history[-1])
        t3 = time.perf_counter()
        phase_s["evaluation"] += t3 - t2

        # 5) one big move per chain, or N // k blocked moves
        if blocked:
            bpr = max(1, n_part // config.blocked_k)
            g = cycle_generator(device, config.master_seed + MOVE_SEED_OFFSET,
                                cycle)
            accepted = torch.zeros((), device=device)
            for _ in range(bpr):
                res = blocked_big_moves(spec, config.beta, state, model,
                                        half_box, config.blocked_k, g,
                                        context_fn)
                state = res.state
                accepted += torch.sum(res.accepted)
            big_move_accepts += float(accepted) / bpr
        else:
            res = big_move(spec, config, state, model, cycle)
            state = res.state
            big_move_accepts += int(torch.sum(res.accepted))
        big_move_attempts += c
        p_acc_history.append(big_move_accepts / big_move_attempts)
        training_samples_history.append(len(train_set))
        t4 = time.perf_counter()
        phase_s["big_move"] += t4 - t3

        # the checkpoint at the cycle's end, and an evaluation
        if (cycle + 1) % (config.checkpoint_interval * 2) == 0:
            save(cycle + 1)
            evaluate(cycle + 1)
        phase_s["evaluation"] += time.perf_counter() - t4

    # final analysis
    t = time.perf_counter()
    figures.append(plot_acceptance_rate(
        p_acc_history, directory, x_values=training_samples_history,
        xlabel="Training samples seen",
        base_filename="p_acc_vs_training_samples"))
    cycles_run = len(p_acc_history) - 1
    results: Dict = {"directory": directory,
                     "big_move_acceptance": p_acc_history[-1],
                     "start_cycle": start_cycle, "cycles_run": cycles_run,
                     "p_acc_history": p_acc_history,
                     "loss_per_cycle": loss_per_cycle, "phase_s": phase_s,
                     "state": state, "model": model}
    if cycles_run > 0:
        # the raw production trajectories, (C, T, N, 2): the sector
        # analysis (tools/a2_recipe.py) re-reads them
        all_traj = np.stack([np.concatenate(production_configs[i], axis=0)
                             for i in range(c)])
        np.save(os.path.join(directory, "production_positions.npy"),
                all_traj.astype(np.float32))
        free_energy_array = []
        for i in range(c):
            traj = all_traj[i]
            start = max(0, len(traj) - config.num_samples_for_free_energy)
            avg_x, p_a, p_b, d_f, runs = calculate_well_statistics(
                traj, start, half_box, config.r0)
            free_energy_array.append(d_f)
            if i < 10:
                run_dir = os.path.join(directory, "mc_runs",
                                       f"run_{i + 1:03d}")
                os.makedirs(run_dir, exist_ok=True)
                figures.append(plot_well_statistics(
                    avg_x, p_a, p_b, d_f, runs, half_box, run_dir))
        min_len = min(len(f) for f in free_energy_array)
        fe = np.asarray([f[:min_len] for f in free_energy_array])
        svg, _, fm, fsem, fstd = plot_avg_free_energy(fe, directory)
        figures.append(svg)
        logger.info("Final mean delta F = %s +- %s", fm, fsem)
        metrics.log("free_energy", mean=fm, sem=fsem, std=fstd)
        phase_s["analysis"] = time.perf_counter() - t
        results.update({"delta_f_mean": fm, "delta_f_sem": fsem,
                        "delta_f_std": fstd})
        write_evidence(config, {
            "driver": "algorithm2",
            "fused": fused, "freeze_after": freeze_after,
            "resumed_from_cycle": start_cycle,
            "delta_f_mean": fm, "delta_f_sem": fsem, "delta_f_std": fstd,
            "delta_f_per_chain_final": [float(f[-1]) if len(f) else None
                                        for f in free_energy_array],
            "big_move_acceptance": p_acc_history[-1],
            "p_acc_history": _thin(p_acc_history),
            "loss_per_cycle": _thin(loss_per_cycle),
            "training_samples_history": _thin(training_samples_history),
            "sector_counts": sector_counts(all_traj, half_box, config.r0),
            "phase_s": phase_s,
        }, device)
    if None in figures:
        logger.info("%d figures not drawn (matplotlib cannot be imported); "
                    "their *_data.json are written", figures.count(None))
    metrics.close()
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description="Hybrid Algorithm 2")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--fused", action="store_true",
                        help="run the cycles in chunks whose results stay "
                             "on the device (training/cycles.py); needs "
                             "the non-cumulative window and alpha=1")
    parser.add_argument("--freeze_after", type=int, default=None,
                        help="finite adaptation: stop retraining the flow "
                             "after this many cycles; the rest sample with "
                             "a fixed kernel")
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args()
    config = algorithm2_config(experiment_id=args.experiment_id,
                               output_dir=args.output_dir)
    run(config, resume=args.resume, fused=args.fused,
        freeze_after=args.freeze_after, device=args.device)


if __name__ == "__main__":
    main()
