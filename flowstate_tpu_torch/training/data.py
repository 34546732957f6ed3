"""Training data for the flow: flatten, dedup, shuffle into batches.

Port of ``flowstate_tpu/training/data.py``.  ``epoch_batches`` (:40)
shuffles with an explicit ``torch.Generator`` on the data's device and
drops the remainder, as the JAX version does; the rest is numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def flatten_configs(configs: np.ndarray, num_particles: int,
                    num_dim: int) -> np.ndarray:
    """(M, N, d) or (M, N*d) -> (M, N*d) float32."""
    arr = np.asarray(configs, dtype=np.float32)
    return arr.reshape(arr.shape[0], num_particles * num_dim)


def dedup_subsample(data: np.ndarray, max_samples: Optional[int] = None,
                    seed: int = 0) -> np.ndarray:
    """Unique rows, then an optional uniform subsample."""
    unique = np.unique(data, axis=0)
    if max_samples is not None and len(unique) > max_samples:
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(unique), size=max_samples, replace=False)
        unique = unique[idx]
    return unique


def epoch_batches(generator: torch.Generator, data: torch.Tensor,
                  batch_size: int) -> torch.Tensor:
    """Shuffle and reshape to (num_batches, batch_size, dim); the last
    ``M % batch_size`` samples of the permutation are dropped."""
    m = data.shape[0]
    num_batches = m // batch_size
    perm = torch.randperm(m, generator=generator, device=data.device)
    return data[perm[: num_batches * batch_size]].reshape(
        num_batches, batch_size, data.shape[-1])


def sliding_window_update(train_set: np.ndarray, new_samples: np.ndarray,
                          cumulative: bool,
                          window_size: Optional[int] = None) -> np.ndarray:
    """Algorithm 2's training set: everything (``cumulative``), else the
    newest ``window_size`` rows (default: the new samples alone)."""
    if cumulative:
        return np.concatenate([train_set, new_samples], axis=0)
    if window_size is None:
        return np.asarray(new_samples)
    merged = np.concatenate([train_set, new_samples], axis=0)
    return merged[-window_size:]
