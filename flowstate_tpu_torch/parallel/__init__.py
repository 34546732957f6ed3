"""The multi-device layer over ``torch.distributed``: the chain mesh, its
shardings and collectives, the data-parallel training step, and the
launcher that runs one process a rank."""

from flowstate_tpu_torch.parallel.launch import run_ranks
from flowstate_tpu_torch.parallel.mesh import (
    ChainMesh, all_gather_samples, exchange_edge_rows, initialize_distributed,
    make_chain_mesh, make_data_parallel_train_step, psum_counter,
    rank_generator, replicate, shard_batch, shard_chain_state, shard_rows,
)

__all__ = [
    "ChainMesh", "initialize_distributed", "make_chain_mesh", "shard_rows",
    "shard_chain_state", "shard_batch", "replicate", "rank_generator",
    "psum_counter", "all_gather_samples", "exchange_edge_rows",
    "make_data_parallel_train_step", "run_ranks",
]
