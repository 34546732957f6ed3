"""Algorithm 2's cycles as one runner over a chunk, results on the device.

Port of ``flowstate_tpu/training/cycles.py::make_fused_cycles``.  The JAX
version folds a chunk of cycles into one ``lax.scan``; here the chunk is a
Python loop whose per-cycle results (losses, accept counts, positions)
stay on the device until the chunk ends.  Each cycle runs, in order:

  1. production: ``update_num_samples / C`` samples per chain through
     ``run_production_kernel`` (the move kernel, then a pair-energy resync
     per sample);
  2. a fresh Adam for ``epochs`` epochs over exactly that cycle's window
     (skipped, losses NaN, when the runner is frozen);
  3. one flow big move per chain (``nf_big_moves``, the proposals'
     energies through the pair-energy kernel).

Every cycle's training and big-move generators come from
``cycle_generator(master_seed + 4, cycle)`` and ``(master_seed + 3,
cycle)``, as in the driver's host loop, so the runner and the host loop
give bit-equal results on the CPU.  As in JAX the runner needs the
non-cumulative window and the pure forward-KLD loss (``check_fused``).

With a ``mesh`` (``parallel.ChainMesh``) the state is this rank's shard:
production runs on its chains, every rank trains on the pool of every
rank's window (``all_gather_samples``, in rank order: the unsharded
window), so the flow's parameters stay equal on every rank, and each
rank's big move draws from the cycle's generator folded with its rank.
"""

from __future__ import annotations

import torch

from flowstate_tpu_torch.mcmc.cuda_metropolis import run_production_kernel
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves, to_centered
from flowstate_tpu_torch.parallel.mesh import (
    all_gather_samples, rank_generator,
)
from flowstate_tpu_torch.training.train import (
    TrainConfig, make_optimizer, make_train_step, train_epoch,
)

TRAIN_SEED_OFFSET = 4
MOVE_SEED_OFFSET = 3


def cycle_generator(device, seed: int, cycle: int) -> torch.Generator:
    """A generator on ``device`` seeded by ``(seed, cycle)``, one stream
    per pair (each 32 bits)."""
    return torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (cycle & 0xFFFFFFFF))


def train_config(config) -> TrainConfig:
    return TrainConfig(batch_size=config.batch_size, epochs=config.epochs,
                       lr=config.lr, weight_decay=config.weight_decay,
                       alpha=config.alpha)


def check_fused(config) -> None:
    """The JAX runner's conditions: global big moves, a static window and
    alpha = 1."""
    if config.blocked_k > 0:
        raise ValueError("blocked_k is only supported by the host-driven "
                         "cycle loop (fused=False)")
    if config.cumulative_training_samples:
        raise ValueError("fused cycles need the non-cumulative window "
                         "(static train-set shape)")
    if config.alpha < 1.0:
        raise ValueError("fused cycles support the alpha=1.0 (pure fKLD) "
                         "regime the reference's full scale uses")


def big_move(spec, config, state, model, cycle: int, mesh=None):
    """Cycle ``cycle``'s big move: one flow proposal per chain, its
    proposals and uniforms from ``(master_seed + 3, cycle)``, folded with
    the rank when a ``mesh`` is given."""
    g = cycle_generator(state.device, config.master_seed + MOVE_SEED_OFFSET,
                        cycle)
    if mesh is not None:
        g = rank_generator(g.initial_seed(), mesh)
    return nf_big_moves(spec, config.beta, state, model, config.half_box, g,
                        paired=False)


def make_fused_cycles(model, spec, config, n_cycles: int,
                      train: bool = True, mesh=None):
    """A runner for ``n_cycles`` Algorithm-2 cycles of ``model`` (trained
    in place): ``run(state, start_cycle) -> (state, out)`` with ``out =
    {"loss": (n, epochs), "accepts": (n,), "positions": (n, C, T, N, 2)}``
    on the state's device.

    ``train=False`` builds frozen cycles, the finite-adaptation mode:
    production and big moves with the flow's parameters unchanged, the
    losses NaN.  ``mesh``: run on this rank's shard of the chains, as the
    module's docstring says.
    """
    check_fused(config)
    c = config.num_chains
    samples_per_chain = max(1, config.update_num_samples // c)
    cfg = train_config(config)

    def run(state, start_cycle: int):
        dev = state.device
        losses, accepts, positions = [], [], []
        for cycle in range(start_cycle, start_cycle + n_cycles):
            state, obs = run_production_kernel(
                spec, config.beta, state, samples_per_chain,
                config.sampling_frequency)
            if train:
                window = to_centered(
                    obs.positions.reshape(-1, spec.num_particles, 2),
                    config.half_box).to(model.dtype)
                if mesh is not None:
                    window = all_gather_samples(window, mesh)
                g = cycle_generator(
                    dev, config.master_seed + TRAIN_SEED_OFFSET, cycle)
                optimizer = make_optimizer(cfg)
                step = make_train_step(model, cfg, optimizer)
                opt_state = optimizer.init(list(model.parameters()))
                epoch_losses = []
                for _ in range(cfg.epochs):
                    opt_state, batch_losses = train_epoch(
                        step, opt_state, window, g, cfg.batch_size)
                    epoch_losses.append(torch.mean(batch_losses))
                losses.append(torch.stack(epoch_losses))
            else:
                losses.append(torch.full((cfg.epochs,), float("nan"),
                                         device=dev))
            res = big_move(spec, config, state, model, cycle, mesh)
            state = res.state
            accepts.append(torch.sum(res.accepted.to(torch.int32)))
            positions.append(obs.positions)
        return state, {"loss": torch.stack(losses),
                       "accepts": torch.stack(accepts),
                       "positions": torch.stack(positions)}

    return run
