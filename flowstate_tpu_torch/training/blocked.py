"""Training of the blocked moves' conditional flow.

Port of ``flowstate_tpu/training/blocked.py``: ``blocked_pairs`` (:32),
``make_blocked_train_step`` (:52) and ``train_blocked`` (:74).
Conditional maximum likelihood on (block, context) pairs cut from
configurations: every epoch draws a fresh random block per configuration
(the distribution the sampler proposes from, ``mcmc/blocked.py``) and a
new shuffle, and drops the last partial batch.  The loss is
``-mean(log q(x_block | context))``; the update is the port's written-out
Adam (``training/train.py``), whose NaN skip advances the moments and the
count and leaves the parameters where they were.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from flowstate_tpu_torch.mcmc.blocked import (
    ContextFn, block_context, random_block_perm, select_particles,
)
from flowstate_tpu_torch.training.train import (
    Adam, AdamState, TrainConfig, make_optimizer,
)


def blocked_pairs(generator: torch.Generator, configs: torch.Tensor, k: int,
                  half_box: float, context_fn: Optional[ContextFn] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, N, 2) box-frame configurations -> ``(x, ctx)``: one random
    block per configuration, centred and flattened (S, 2k), and its
    context (S, F) from ``context_fn`` (default ``block_context``)."""
    s, n = configs.shape[:2]
    if context_fn is None:
        context_fn = lambda r, p: block_context(r, p, half_box)  # noqa: E731
    perm = random_block_perm(s, n, generator, configs.device)
    x = (select_particles(perm[:, :k], configs) - half_box).reshape(s, -1)
    return x, context_fn(perm[:, k:], configs)


def make_blocked_train_step(model, optimizer: Adam
                            ) -> Callable[[AdamState, Tuple], Tuple]:
    """One batch's conditional-MLE update of ``model``'s parameters, in
    place: ``step(opt_state, (x, ctx)) -> (opt_state, loss)``; a
    non-finite loss leaves the parameters and advances the optimizer."""
    params = list(model.parameters())

    def step(opt_state: AdamState, batch):
        x, ctx = batch
        loss = model.forward_kld(x, ctx)
        grads = torch.autograd.grad(loss, params)
        finite = torch.isfinite(loss)
        grads = [torch.where(finite, torch.nan_to_num(g), torch.zeros_like(g))
                 for g in grads]
        opt_state = optimizer.update(grads, opt_state, params, finite)
        return opt_state, loss.detach()

    return step


def train_blocked(model, configs: torch.Tensor, k: int, half_box: float,
                  config: TrainConfig, generator: torch.Generator,
                  opt_state: Optional[AdamState] = None,
                  context_fn: Optional[ContextFn] = None):
    """``config.epochs`` epochs of conditional MLE over (S, N, 2) box-frame
    configurations, on the model's device; ``generator`` (there too)
    draws each epoch's blocks and shuffle.  Returns ``(params, opt_state,
    loss_epoch)``: the model's named parameters (trained in place), the
    optimizer state and each epoch's mean finite loss."""
    configs = configs.to(model.device, model.dtype)
    s = configs.shape[0]
    n_steps = s // config.batch_size
    if n_steps == 0:
        raise ValueError(f"{s} configs < batch_size {config.batch_size}")
    optimizer = make_optimizer(config)
    if opt_state is None:
        opt_state = optimizer.init(list(model.parameters()))
    step = make_blocked_train_step(model, optimizer)
    loss_epoch: List[float] = []
    for _ in range(config.epochs):
        x, ctx = blocked_pairs(generator, configs, k, half_box, context_fn)
        order = torch.randperm(s, generator=generator,
                               device=configs.device)[:n_steps
                                                      * config.batch_size]
        x = x[order].reshape(n_steps, config.batch_size, -1)
        ctx = ctx[order].reshape(n_steps, config.batch_size, -1)
        losses = []
        for i in range(n_steps):
            opt_state, loss = step(opt_state, (x[i], ctx[i]))
            losses.append(loss)
        losses = torch.stack(losses).cpu()
        finite = losses[torch.isfinite(losses)]
        loss_epoch.append(float(finite.mean()) if finite.numel()
                          else float("nan"))
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())
    return params, opt_state, loss_epoch
