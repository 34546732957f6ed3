"""The multi-device layer: chains and training batches over ranks.

Port of ``flowstate_tpu/parallel/mesh.py`` to ``torch.distributed``.  One
process runs each rank, on ``cuda:{rank}`` over NCCL (the default), or on
the CPU over gloo when the caller passes ``device="cpu"``.  The scaling
axes are the JAX module's:

* chains: rank r holds rows ``[r C / R, (r + 1) C / R)`` of a ``ChainState``
  (``shard_chain_state``) with ``chain_offset`` set, and runs the per-chain
  function on them.  The move kernel keys each chain's randoms on its
  global index and the plain engines keep their rows of the run's whole
  table, so a shard's chains move exactly as in the unsharded run and no
  collective is needed;
* data: every rank trains the same flow on its rows of the batch, and one
  ``all_reduce`` averages the gradients and the loss
  (``make_data_parallel_train_step``).

The JAX names and their counterparts here:

* ``initialize_distributed`` (:32): ``initialize_distributed``, which
  also returns the mesh; ``make_chain_mesh`` (:42): ``make_chain_mesh``, a
  ``ChainMesh`` of the initialised group;
* ``shard_chain_state`` (:61), ``shard_batch`` (:68), ``replicate`` (:72):
  the same names; ``replicate`` broadcasts a module's parameters and
  buffers from rank 0;
* ``chain_sharding`` (:52), ``replicated_sharding`` (:57) and
  ``CHAIN_AXIS``: none.  A rank's tensor is its shard; nothing annotates
  a layout;
* ``sharded_chain_fn`` (:78): none.  Each rank calls the per-chain
  function on its shard; the randoms' global keys above are what
  ``shard_map`` needed no code for;
* ``make_data_parallel_train_step`` (:90), ``psum_counter`` (:149),
  ``all_gather_samples`` (:158): the same names.

Nothing here falls back to the CPU: a CUDA mesh without a card raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS, ChainState
from flowstate_tpu_torch.training.train import Adam, AdamState, TrainConfig


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """This process's place in a 1-D mesh of ranks over the chains."""

    rank: int
    world_size: int
    device: torch.device     # cuda:{rank}, or the CPU

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @property
    def ring_path(self) -> str:
        """How ``exchange_edge_rows`` reaches the neighbours: ``"p2p"``
        (send and receive over the group) or, at world size 1 over gloo,
        which cannot send to itself, ``"local"`` (the rank is its own
        neighbour, so its rows are taken as they are)."""
        if self.world_size == 1 and self.backend == "gloo":
            return "local"
        return "p2p"


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' "
                               "for gloo on the CPU")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _rank_device(device, rank: int) -> torch.device:
    """``cuda:{rank}`` for a CUDA mesh (one card a rank), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank} needs card {rank}, and "
                           f"{torch.cuda.device_count()} are visible "
                           "(NCCL takes one rank a card)")
    return torch.device("cuda", rank)


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device="cuda") -> ChainMesh:
    """Join the process group (``tcp://localhost:<port>`` or
    ``file://<path>``; NCCL on ``cuda:{rank}``, gloo for ``"cpu"``) and
    return its mesh."""
    dev = _rank_device(device, rank)
    backend = _backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return make_chain_mesh(dev)


def make_chain_mesh(device="cuda") -> ChainMesh:
    """The mesh of the initialised (default) process group, on ``device``
    (for a CUDA mesh, this rank's card)."""
    if not dist.is_initialized():
        raise RuntimeError("initialize_distributed first")
    dev = torch.device(device)
    rank = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = _rank_device(dev, rank)
    _backend(dev)
    return ChainMesh(rank, dist.get_world_size(), dev)


def shard_rows(num_rows: int, mesh: ChainMesh) -> slice:
    """This rank's rows of ``num_rows``; a count the ranks do not divide is
    refused, as ``shard_map`` refuses it."""
    if num_rows % mesh.world_size:
        raise ValueError(f"{num_rows} rows do not split over "
                         f"{mesh.world_size} ranks")
    n = num_rows // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_chain_state(state: ChainState, mesh: ChainMesh) -> ChainState:
    """This rank's rows of ``state`` on the mesh's device, with
    ``chain_offset`` and ``total_chains`` set so that its randoms are its
    chains' draws of the unsharded run (a state that is itself a shard
    shards further from its own offset)."""
    rows = shard_rows(state.positions.shape[0], mesh)
    return state.replace(
        **{f: getattr(state, f)[rows].to(mesh.device).contiguous()
           for f in TENSOR_FIELDS},
        chain_offset=state.chain_offset + rows.start,
        total_chains=state.num_global_chains)


def shard_batch(batch: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """This rank's rows of ``batch``, on the mesh's device."""
    return batch[shard_rows(batch.shape[0], mesh)].to(mesh.device)


@torch.no_grad()
def replicate(module: nn.Module, mesh: ChainMesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers (on the mesh's
    device) from rank 0, in place; returns ``module``."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def rank_generator(seed: int, mesh: ChainMesh) -> torch.Generator:
    """A generator on the mesh's device seeded from a hash of ``(seed,
    rank)``: ranks draw different streams from one shared seed, as JAX's
    ``fold_in`` of the shard index."""
    digest = hashlib.blake2b(f"{seed},{mesh.rank}".encode(),
                             digest_size=8).digest()
    g = torch.Generator(device=mesh.device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def psum_counter(value: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """The sum over every rank of the sum of ``value`` (acceptance counts,
    well histograms): one ``all_reduce``."""
    total = torch.sum(value).to(mesh.device)
    dist.all_reduce(total)
    return total


def all_gather_samples(samples: torch.Tensor, mesh: ChainMesh
                       ) -> torch.Tensor:
    """Every rank's ``samples`` (equal shapes) concatenated along axis 0 in
    rank order, on every rank: one all-gather into one tensor."""
    samples = samples.contiguous()
    out = samples.new_empty((mesh.world_size * samples.shape[0],)
                            + tuple(samples.shape[1:]))
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(out, samples)
    return out


def exchange_edge_rows(rows: torch.Tensor, mesh: ChainMesh):
    """``(prev_last, next_first)``: the left neighbour's last row and the
    right neighbour's first row of ``rows`` (leading axis the local rows),
    around the ring of ranks.  Each rank sends its last row right and its
    first row left in one ``batch_isend_irecv``; at the ring's ends the
    rows wrap, and the caller masks them off."""
    last, first = rows[-1].contiguous(), rows[0].contiguous()
    if mesh.ring_path == "local":
        return last, first
    r, w = mesh.rank, mesh.world_size
    right, left = (r + 1) % w, (r - 1) % w
    prev_last, next_first = torch.empty_like(last), torch.empty_like(first)
    # the two sends leave in the same order as every rank posts its two
    # receives, so at world size 2 (left == right) each message meets its
    # own receive
    ops = [dist.P2POp(dist.isend, last, right),
           dist.P2POp(dist.isend, first, left),
           dist.P2POp(dist.irecv, prev_last, left),
           dist.P2POp(dist.irecv, next_first, right)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return prev_last, next_first


def make_data_parallel_train_step(model, config: TrainConfig,
                                  optimizer: Adam, mesh: ChainMesh,
                                  generator: Optional[torch.Generator] = None):
    """The data-parallel counterpart of ``training/train.py::
    make_train_step``: ``step(opt_state, batch_shard) -> (opt_state,
    loss)`` with ``batch_shard`` this rank's rows (``shard_batch``).

    Each rank takes its local loss and gradients; the gradients and the
    loss go into one flat buffer, which one ``all_reduce`` sums and the
    world size divides.  The finiteness test reads the averaged loss, so
    every rank masks the same step, and every rank makes the same Adam
    update.  At ``alpha = 1`` the step equals the single step (a mean of
    equal shards' means is the batch's mean; at world size 1, bit for
    bit).  The reverse term draws ``reverse_num_samples // world`` base
    points a rank from ``rank_generator(generator.initial_seed(), mesh)``,
    so the ranks' draws differ, as JAX's ``fold_in`` makes them.

    ``nn.parallel.DistributedDataParallel`` does not fit: its hooks fire
    on ``.backward()``, and this step takes ``torch.autograd.grad``.
    """
    if config.alpha < 1.0 and generator is None:
        raise ValueError("the reverse-KLD term (alpha < 1) needs a "
                         "generator for its base samples")
    params: List[torch.Tensor] = list(model.parameters())
    local_generator = (rank_generator(generator.initial_seed(), mesh)
                       if generator is not None else None)
    local_samples = config.reverse_num_samples // mesh.world_size

    def step(opt_state: AdamState, batch_shard: torch.Tensor):
        loss = None
        if config.alpha > 0.0:
            loss = config.alpha * model.forward_kld(batch_shard)
        if config.alpha < 1.0:
            rkld, _ = model.reverse_kld(local_samples, local_generator)
            rkld = (1.0 - config.alpha) * rkld
            loss = rkld if loss is None else loss + rkld
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat)
        flat = flat / mesh.world_size
        loss = flat[-1].to(loss.dtype)
        finite = torch.isfinite(loss)
        grads = [torch.where(finite, torch.nan_to_num(g), torch.zeros_like(g))
                 for g in _unflatten(flat, params)]
        opt_state = optimizer.update(grads, opt_state, params, finite)
        return opt_state, loss

    return step


def _unflatten(flat: torch.Tensor, like: List[torch.Tensor]
               ) -> List[torch.Tensor]:
    out, start = [], 0
    for p in like:
        out.append(flat[start:start + p.numel()].view_as(p).to(p.dtype))
        start += p.numel()
    return out
