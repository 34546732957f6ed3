"""One process a rank: the launcher of the multi-device layer.

``run_ranks`` spawns ``world_size`` processes (the ``spawn`` start method,
so each imports the package afresh), each of which joins the process group
(``mesh.initialize_distributed``), runs the given calls in order as
``fn(mesh, *args)``, writes its results and leaves the group.  The parent
waits for every rank within a time limit: a rank that exits with another
code than 0 ends the run at once (the others are killed, since they may
wait in a collective for it), and so does the limit.  The functions and
their arguments are pickled, so they are module-level functions (or
``functools.partial`` of them) and picklable values.
"""

from __future__ import annotations

import copy
import dataclasses
import multiprocessing
import multiprocessing.connection
import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flowstate_tpu_torch.parallel.mesh import initialize_distributed

Call = Tuple[Callable[..., Any], tuple]


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<port>`` with a port that was free just now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def to_host(obj):
    """``obj`` with every tensor moved to the CPU and every dataclass or
    named tuple (``ChainState``, ``SwapResult``) turned into a dict of its
    fields."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_asdict"):
        return {k: to_host(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               calls: Sequence[Call], out_dir: str) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)     # R ranks on R cores
    # a CPU tensor sent to a spawned process shares its memory with every
    # other receiver: each rank takes its own copy of what it is given
    calls = copy.deepcopy(calls)
    mesh = initialize_distributed(init_method, world_size, rank, device)
    try:
        results = [to_host(fn(mesh, *args)) for fn, args in calls]
        dist.barrier()
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _wait(procs: List[multiprocessing.Process], timeout: float) -> None:
    deadline = time.monotonic() + timeout
    pending = list(procs)
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"{', '.join(p.name for p in pending)} still running after "
                f"{timeout:.0f} s")
        ready = multiprocessing.connection.wait(
            [p.sentinel for p in pending], timeout=left)
        for p in [p for p in pending if p.sentinel in ready]:
            p.join()
            pending.remove(p)
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} exited with code {p.exitcode}")


def run_ranks(calls: Sequence[Call], world_size: int, device="cuda",
              init_method: Optional[str] = None,
              timeout: float = 600.0) -> List[list]:
    """Run ``calls`` (``(fn, args)`` pairs, each called as ``fn(mesh,
    *args)``) on ``world_size`` ranks, one spawned process each, over NCCL
    on ``cuda:{rank}`` or over gloo for ``device="cpu"``; returns
    ``results[rank][i]``, the i-th call's result on that rank passed
    through ``to_host``.  ``init_method`` defaults to a free local TCP
    port.  Raises if a rank fails or the run outlasts ``timeout`` seconds;
    no process outlives the call."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} CUDA ranks need {world_size} cards "
                           f"(NCCL takes one rank a card); "
                           f"{torch.cuda.device_count()} are visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        init = init_method or free_tcp_address()
        procs = [ctx.Process(target=_rank_main, name=f"rank {rank}",
                             args=(rank, world_size, init, str(device),
                                   list(calls), out_dir))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            _wait(procs, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        return [torch.load(os.path.join(out_dir, f"rank{rank}.pt"),
                           weights_only=False)
                for rank in range(world_size)]
