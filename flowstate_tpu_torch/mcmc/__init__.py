"""Batched MCMC: chain state, the plain engine, the move kernel, the flow's
big moves, the blocked conditional moves, parallel tempering, MALA and
HMC."""

from flowstate_tpu_torch.mcmc.blocked import (
    apply_blocked_moves, block_context, blocked_big_moves, context_dim,
    fourier_context, fourier_context_dim, random_block_perm, scatter_block,
    select_particles,
)
from flowstate_tpu_torch.mcmc.cuda_metropolis import (
    run_moves_auto, run_moves_kernel, run_moves_plain, run_production_kernel,
)
from flowstate_tpu_torch.mcmc.hmc import (
    DEFAULT_NUM_LEAPFROG, HMC_TARGET_ACCEPTANCE, adjust_eps, hmc_apply,
    hmc_move, run_hmc, run_hmc_batch, run_hmc_equilibration,
    run_hmc_equilibration_batch,
)
from flowstate_tpu_torch.mcmc.hybrid import (
    BigMoveResult, apply_big_moves, bulk_judge_flow, judge_flow,
    nf_big_moves, to_box_frame, to_centered,
)
from flowstate_tpu_torch.mcmc.initialise import (
    init_alternating_wells,
    init_split_wells,
    initialise_fcc,
    initialise_fcc_left_half,
    initialise_fcc_right_half,
    initialise_low_left,
    initialise_low_right,
)
from flowstate_tpu_torch.mcmc.mala import (
    MALA_TARGET_ACCEPTANCE, adjust_tau, mala_apply, potential_gradient,
    run_mala, run_mala_equilibration,
)
from flowstate_tpu_torch.mcmc.metropolis import (
    Observables,
    adjust_displacement,
    apply_move,
    draw_tables,
    metropolis_move,
    run_equilibration,
    run_equilibration_batch,
    run_moves,
    run_moves_batch,
    run_production,
    run_production_batch,
    run_production_with,
    run_production_with_batch,
    sample_observables,
)
from flowstate_tpu_torch.mcmc.observables import (
    acceptance_fraction,
    check_equilibration,
    ensemble_acceptance,
)
from flowstate_tpu_torch.mcmc.state import (
    ChainState, chain_state_from_numpy, init_chain_state, resync_energy,
)
from flowstate_tpu_torch.mcmc.tempering import (
    ReplicaExchangeResult, SwapResult, chain_betas, init_tempered_state,
    replica_view, run_replica_exchange, run_tempered_moves, swap_replicas,
    swap_replicas_replica_sharded, temperature_ladder,
)

__all__ = [
    "ChainState", "init_chain_state", "chain_state_from_numpy",
    "resync_energy",
    "apply_move", "draw_tables", "metropolis_move", "run_moves",
    "run_moves_batch", "adjust_displacement", "Observables",
    "sample_observables", "run_production", "run_production_batch",
    "run_production_with", "run_production_with_batch",
    "run_equilibration", "run_equilibration_batch",
    "run_moves_kernel", "run_moves_plain", "run_moves_auto",
    "run_production_kernel",
    "init_alternating_wells", "init_split_wells", "initialise_fcc",
    "initialise_low_left", "initialise_low_right",
    "initialise_fcc_left_half", "initialise_fcc_right_half",
    "check_equilibration", "acceptance_fraction", "ensemble_acceptance",
    "BigMoveResult", "to_centered", "to_box_frame", "nf_big_moves",
    "apply_big_moves", "judge_flow", "bulk_judge_flow",
    "random_block_perm", "select_particles", "scatter_block",
    "block_context", "context_dim", "fourier_context", "fourier_context_dim",
    "blocked_big_moves", "apply_blocked_moves",
    "temperature_ladder", "chain_betas", "replica_view",
    "init_tempered_state", "run_tempered_moves", "SwapResult",
    "swap_replicas", "swap_replicas_replica_sharded",
    "ReplicaExchangeResult", "run_replica_exchange",
    "potential_gradient", "mala_apply", "run_mala", "adjust_tau",
    "run_mala_equilibration", "MALA_TARGET_ACCEPTANCE",
    "hmc_apply", "hmc_move", "run_hmc", "run_hmc_batch", "adjust_eps",
    "run_hmc_equilibration", "run_hmc_equilibration_batch",
    "HMC_TARGET_ACCEPTANCE", "DEFAULT_NUM_LEAPFROG",
]
