"""Checkpoint and resume: the flow, the chain state and the train set.

Port of ``flowstate_tpu/utils/checkpoint.py``, Orbax replaced by
``torch.save``.  The layout stays ``directory/step_<%08d>/`` with the tree
in ``tree.pt`` and the metadata in ``metadata.json``; ``latest_checkpoint``
picks the highest ``step_*`` and skips names that do not parse, as the JAX
version does.  A checkpoint is written under ``step_<n>.tmp`` and renamed,
so a run cut while writing leaves no ``step_<n>`` behind.

The tree (``experiment_tree``) holds CPU tensors:

* ``flow``: the flow's parameters leaf by leaf in the JAX pytree layout,
  which ``flows.params_from_jax`` / ``params_to_jax`` carry both ways (the
  blocked runs' conditional flow too, its blocks' ``ctx`` leaves beside
  ``l1`` and ``l2``);
* ``chains``: the chain state by field name, with ``seed`` and ``calls``
  (restoring ``calls`` carries the move kernel's Philox counter on, so a
  resumed chain continues its own stream);
* ``train_set``: the training set (M, dim), so that a resumed cumulative
  run trains on what it had (the JAX checkpoint holds only the flow and
  the chains, and its driver restarts from a zero train set: ROADMAP R7).

Algorithm 2 draws a fresh Adam every cycle and derives its generators from
``(master_seed, cycle)``, so neither optimizer nor generator state is
saved.  ``restore_checkpoint`` loads with ``weights_only=True`` onto the
CPU; the caller moves what it needs to its device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from flowstate_tpu_torch.flows import params_to_jax, tree_map
from flowstate_tpu_torch.mcmc.state import (
    TENSOR_FIELDS, ChainState, chain_state_from_numpy,
)

TREE_FILE = "tree.pt"
METADATA_FILE = "metadata.json"


def flow_tree(model) -> tuple:
    """The flow's parameters in the JAX layout, as CPU tensors (copies)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    params_to_jax(model))


def chain_state_tree(state: ChainState) -> Dict[str, Any]:
    """The chain state's tensors on the CPU, with ``seed`` and ``calls``."""
    tree: Dict[str, Any] = {f: getattr(state, f).detach().cpu().clone()
                            for f in TENSOR_FIELDS}
    tree.update(seed=int(state.seed), calls=int(state.calls))
    return tree


def chain_state_from_tree(tree: Dict[str, Any], device) -> ChainState:
    """The state ``chain_state_tree`` saved, on ``device``."""
    return chain_state_from_numpy(tree, tree["seed"], device).replace(
        calls=int(tree["calls"]))


def experiment_tree(model, state: ChainState,
                    train_set: np.ndarray) -> Dict[str, Any]:
    """What Algorithm 2 saves: flow, chain state and train set."""
    return {"flow": flow_tree(model), "chains": chain_state_tree(state),
            "train_set": torch.from_numpy(np.array(train_set,
                                                   dtype=np.float32))}


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Save ``tree`` (CPU tensors, dicts, lists, numbers) at
    ``directory/step_<step>``, replacing one that is there."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, TREE_FILE))
    if metadata is not None:
        with open(os.path.join(tmp, METADATA_FILE), "w") as f:
            json.dump(metadata, f, indent=2)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    """``(step, path)`` of the highest ``step_*`` under ``directory``."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name[5:]), os.path.join(directory, name)))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(path: str) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """The tree and metadata ``save_checkpoint`` wrote at ``path``, the
    tree's tensors on the CPU."""
    tree = torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                      weights_only=True)
    meta_path = os.path.join(path, METADATA_FILE)
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return tree, metadata
