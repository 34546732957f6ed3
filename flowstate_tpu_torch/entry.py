"""Entry points: a one-card forward step and the multi-device dry run.

Port of ``__graft_entry__.py``.  ``entry`` (:8) returns ``(fn, args)``,
the forward KLD of Algorithm 1's flow (K=15 circular couplings, hidden
256, 32 bins over the 3-particle torus) on a batch of 512.
``dryrun_multichip`` (:32) runs the JAX dry run's steps on
``n_devices`` ranks, one process each (``parallel/launch.py``), over NCCL
on the cards or over gloo on the CPU, at its tiny shapes (4 chains a
rank, K=2, hidden 16):

  1. sharded production: the move kernel on each rank's chains, the
     accept count summed over ranks (after a check of the collectives);
  2. a data-parallel training step (``parallel/mesh.py``);
  3. flow big moves on the sharded state (proposal energies through the
     pair-energy kernel);
  4. Algorithm 2's fused cycles on the sharded state, every rank training
     on the pool of every rank's samples; the flow's parameters are then
     checked equal on every rank;
  5. parallel tempering with the replicas over the ranks (two a rank),
     two rounds: local moves at each replica's beta, then an exchange
     sweep, whose pairs cross the ranks in the first round (parity 1);
  6. sharded MALA and 7. sharded HMC;
  8. blocked conditional-flow moves on the sharded state.

A failed check raises on its rank, and ``run_ranks`` raises for any rank
that does not exit 0.  ``production_step``, ``collectives_step``,
``train_step`` and ``pt_step`` are steps 1, 2 and 5 as functions of
their inputs, which run alone on any number of ranks.

    python -m flowstate_tpu_torch.entry [--device cpu] [--ranks R]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from flowstate_tpu_torch.flows import (
    build_circular_flow, build_conditional_circular_flow,
)
from flowstate_tpu_torch.flows.convert import params_to_jax
from flowstate_tpu_torch.mcmc import cuda_metropolis
from flowstate_tpu_torch.mcmc.blocked import (
    blocked_big_moves, fourier_context, fourier_context_dim,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import run_moves_auto
from flowstate_tpu_torch.mcmc.hmc import run_hmc
from flowstate_tpu_torch.mcmc.hybrid import nf_big_moves
from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
from flowstate_tpu_torch.mcmc.mala import run_mala
from flowstate_tpu_torch.mcmc.state import init_chain_state, resync_energy
from flowstate_tpu_torch.mcmc.tempering import (
    init_tempered_state, run_tempered_moves, swap_replicas_replica_sharded,
    temperature_ladder,
)
from flowstate_tpu_torch.experiments.common import build_system
from flowstate_tpu_torch.ops import cuda_pair
from flowstate_tpu_torch.parallel.launch import run_ranks
from flowstate_tpu_torch.parallel.mesh import (
    all_gather_samples, make_data_parallel_train_step, psum_counter,
    rank_generator, replicate, shard_batch, shard_chain_state, shard_rows,
)
from flowstate_tpu_torch.training.cycles import make_fused_cycles
from flowstate_tpu_torch.training.train import TrainConfig, make_optimizer
from flowstate_tpu_torch.utils.config import algorithm2_config

A1_HALF_BOX = ((3 / 0.03) ** 0.5) / 2    # 5.0
A1_FLOW = dict(K=15, hidden_units=256, num_bins=32, num_blocks=2)
A1_BATCH = 512
# the dry run's flow, chains a rank and half box, as __graft_entry__.py's
DRY_FLOW = dict(K=2, hidden_units=16, num_bins=4)
DRY_CHAINS_PER_RANK = 4
DRY_HALF_BOX = 5.0

SAMPLERS = {"metropolis": run_moves_auto, "mala": run_mala, "hmc": run_hmc}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the CPU")
    return dev


def forward_kld(model, batch: torch.Tensor) -> torch.Tensor:
    return model.forward_kld(batch)


def entry(device="cuda"):
    """``(fn, (model, batch))``: ``fn(model, batch)`` is Algorithm 1's
    forward-KLD objective, one inverse sweep through K=15 couplings with
    the log-determinants, on 512 points of the torus; the flow's weights
    and the batch drawn from seed 0 on ``device``."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_circular_flow(3, 2, A1_HALF_BOX, **A1_FLOW, generator=g,
                                device=dev)
    batch = (2.0 * torch.rand((A1_BATCH, 6), generator=g, device=dev)
             - 1.0) * A1_HALF_BOX
    return forward_kld, (model, batch)


def _require(cond: bool, what: str, mesh) -> None:
    if not cond:
        raise RuntimeError(f"rank {mesh.rank}: {what}")


def production_step(mesh, spec, state, beta, num_moves: int,
                    sampler: str = "metropolis", **kwargs):
    """``num_moves`` moves of ``sampler`` (``"metropolis"``: the move
    kernel on the card; ``"mala"``, ``"hmc"``) on this rank's rows of
    ``state``, the whole run's state; returns the rank's shard."""
    return SAMPLERS[sampler](spec, beta, shard_chain_state(state, mesh),
                             num_moves, **kwargs)


def collectives_step(mesh, values: torch.Tensor) -> dict:
    """``psum_counter`` and ``all_gather_samples`` of this rank's rows of
    ``values``."""
    shard = shard_batch(values, mesh)
    return {"psum": psum_counter(shard, mesh),
            "gathered": all_gather_samples(shard, mesh)}


def train_step(mesh, model, config: TrainConfig, batch: torch.Tensor,
               seed: int = 0, steps: int = 1) -> dict:
    """``steps`` data-parallel steps of ``model`` (moved to the rank's
    device, replicated from rank 0 and trained in place) on this rank's
    rows of ``batch``; the reverse term's draws from
    ``rank_generator(seed, mesh)``.  Returns the losses and the flow's
    parameters in the JAX layout."""
    model = replicate(model.to(mesh.device), mesh)
    optimizer = make_optimizer(config)
    step = make_data_parallel_train_step(
        model, config, optimizer, mesh,
        torch.Generator(device=mesh.device).manual_seed(seed))
    opt_state = optimizer.init(list(model.parameters()))
    shard = shard_batch(batch.to(model.dtype), mesh)
    losses = []
    for _ in range(steps):
        opt_state, loss = step(opt_state, shard)
        losses.append(loss)
    return {"losses": torch.stack(losses), "params": params_to_jax(model)}


def pt_step(mesh, spec, betas: torch.Tensor, state, num_moves: int,
            parity: int, u=None, seed: int = 0, rounds: int = 1):
    """Parallel tempering with the replicas over the ranks: this rank's
    whole replicas of the replica-major ``state`` run ``rounds`` rounds,
    each ``num_moves`` local moves at their betas (one move-kernel launch
    on the card) and one replica-sharded exchange sweep, the first of
    ``parity`` and then alternating; the first sweep's uniforms are ``u``
    if given, the others drawn from ``seed`` alike on every rank.
    Returns the last round's ``SwapResult`` (this rank's rows)."""
    betas = betas.to(mesh.device)
    local_betas = betas[shard_rows(betas.shape[0], mesh)]
    shard = shard_chain_state(state, mesh)
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    for i in range(rounds):
        shard = run_tempered_moves(spec, local_betas, shard, num_moves)
        res = swap_replicas_replica_sharded(
            betas, shard, g, (parity + i) % 2, mesh,
            u.to(mesh.device) if u is not None and i == 0 else None)
        shard = res.state
    return res


def _params_agree(model, mesh) -> bool:
    """Whether every rank holds the same parameters, by the max and min
    over ranks of a float64 checksum."""
    total = sum(p.detach().double().sum() for p in model.parameters())
    both = torch.stack([total, -total])
    torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX)
    return bool(both[0] == -both[1])


def dryrun_rank(mesh) -> dict:
    """The dry run's eight steps on this rank (the module's docstring)."""
    dev, world = mesh.device, mesh.world_size
    chains = DRY_CHAINS_PER_RANK * world
    # the reference system (N=3, rho=0.03, two wells), as A2's preset has it
    cfg = algorithm2_config(num_chains=chains, update_num_samples=2 * chains,
                            batch_size=chains, epochs=1, hidden_units=16,
                            num_bins=4, K=2, sampling_frequency=2)
    spec, beta, half_box = build_system(cfg), cfg.beta, DRY_HALF_BOX
    k1_before, k2_before = cuda_metropolis.LAUNCHES, cuda_pair.LAUNCHES

    # 1) the collectives, then sharded production
    ids = torch.arange(chains, device=dev)
    col = collectives_step(mesh, ids)
    _require(int(col["psum"]) == chains * (chains - 1) // 2
             and torch.equal(col["gathered"], ids), "collectives", mesh)
    positions = torch.as_tensor(init_alternating_wells(chains, 3, 0.03)[0],
                                device=dev)
    state = production_step(mesh, spec,
                            init_chain_state(spec, positions, 1, 0.65),
                            beta, 8)
    accepts = int(psum_counter(state.accepts, mesh))
    _require(0 <= accepts <= 8 * chains, f"{accepts} accepts", mesh)
    state = resync_energy(spec, state)

    # 2) a data-parallel training step on the pooled positions (the flow
    # trained in place)
    model = build_circular_flow(
        3, 2, half_box, **DRY_FLOW, num_blocks=1,
        generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = all_gather_samples(state.positions, mesh).reshape(chains, 6)
    loss = train_step(mesh, model, TrainConfig(batch_size=chains, lr=1e-3),
                      batch - half_box)["losses"][0]
    _require(bool(torch.isfinite(loss)), "the DP step's loss is not finite",
             mesh)

    # 3) flow big moves on the sharded state
    res = nf_big_moves(spec, beta, state, model, half_box,
                       rank_generator(3, mesh))
    state = res.state
    _require(state.positions.shape == (DRY_CHAINS_PER_RANK, 3, 2),
             "big moves' shape", mesh)

    # 4) Algorithm 2's fused cycles, trained on every rank's samples
    state, out = make_fused_cycles(model, spec, cfg, 2, mesh=mesh)(state, 0)
    _require(bool(torch.isfinite(out["loss"]).all()),
             "fused cycles' loss is not finite", mesh)
    _require(_params_agree(model, mesh),
             "the flow's parameters differ between ranks", mesh)

    # 5) parallel tempering with the replicas over the ranks
    r, walkers = 2 * world, 4
    pos_pt = np.tile(init_alternating_wells(walkers, 3, 0.03)[0][None],
                     (r, 1, 1, 1))
    st_pt = init_tempered_state(spec, torch.as_tensor(pos_pt, device=dev),
                                5, 0.65)
    swap = pt_step(mesh, spec, temperature_ladder(1.0, 8.0, r, device=dev),
                   st_pt, 4, parity=1, seed=6, rounds=2)
    _require(swap.state.positions.shape == (2 * walkers, 3, 2),
             "tempering's shape", mesh)

    # 6) sharded MALA and 7) sharded HMC
    for sampler, seed, kwargs in (("mala", 7, {}),
                                  ("hmc", 8, {"num_leapfrog": 3})):
        moved = production_step(mesh, spec,
                                init_chain_state(spec, positions, seed, 0.02),
                                beta, 4 if sampler == "mala" else 2, sampler,
                                **kwargs)
        _require(bool(torch.isfinite(moved.energy).all()),
                 f"{sampler}'s energies are not finite", mesh)

    # 8) blocked conditional-flow moves on the sharded state
    cmodel = replicate(build_conditional_circular_flow(
        2, 2, half_box, context_features=fourier_context_dim(2), **DRY_FLOW,
        generator=torch.Generator(device=dev).manual_seed(9), device=dev),
        mesh)
    blocked = blocked_big_moves(
        spec, beta, state, cmodel, half_box, 2, rank_generator(10, mesh),
        context_fn=functools.partial(fourier_context, half_box=half_box,
                                     m_max=2))
    _require(blocked.state.positions.shape == (DRY_CHAINS_PER_RANK, 3, 2),
             "blocked moves' shape", mesh)
    return {"rank": mesh.rank, "backend": mesh.backend,
            "ring_path": mesh.ring_path, "accepts": accepts,
            "dp_loss": float(loss), "fused_loss": out["loss"],
            "swaps": int(swap.accepted.sum()),
            "k1_launches": cuda_metropolis.LAUNCHES - k1_before,
            "k2_launches": cuda_pair.LAUNCHES - k2_before}


def dryrun_multichip(n_devices: int, device="cuda", init_method=None,
                     timeout: float = 600.0) -> list:
    """The dry run's eight steps on ``n_devices`` ranks (``cuda:0`` ...
    over NCCL, or gloo on the CPU for ``device="cpu"``); raises on any
    rank's failure.  Returns each rank's summary: its backend, the ring's
    path, the accept count, the losses, the swaps and its launches of the
    move kernel (K1) and the pair-energy kernel (K2)."""
    _device(device)
    return [r[0] for r in run_ranks([(dryrun_rank, ())], n_devices, device,
                                    init_method, timeout)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=None,
                        help="default: the visible cards, or 2 on the CPU")
    args = parser.parse_args(argv)
    fn, fn_args = entry(args.device)
    with torch.no_grad():
        print("entry loss:", float(fn(*fn_args)))
    ranks = args.ranks or (torch.cuda.device_count()
                           if torch.device(args.device).type == "cuda" else 2)
    for summary in dryrun_multichip(ranks, args.device):
        print(summary)
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main()
