"""Flow training: forward KLD, Adam with coupled weight decay, NaN-skip.

Port of ``flowstate_tpu/training/train.py``: ``TrainConfig`` (:104),
``make_optimizer`` (:117), ``make_train_step`` (:131) and ``train``
(:168).  The JAX step zeroes the gradients of a batch whose loss is not
finite; optax's Adam then still advances its moments and step count, and
only the parameter update is zeroed.  ``torch.optim.Adam`` can do neither
(skipping ``step()`` freezes the count, stepping on zero gradients moves
the parameters by the momentum), so the update is written out here:
``Adam`` follows ``optax.add_decayed_weights`` then ``optax.adam`` (eps
1e-8, bias correction), with the update masked by the loss's finiteness
on the device, so a step needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from flowstate_tpu_torch.training.data import epoch_batches


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (defaults: Algorithm 1 at full scale)."""

    batch_size: int = 512
    epochs: int = 100
    lr: float = 1e-4
    weight_decay: float = 0.0
    alpha: float = 1.0           # fKLD weight; (1-alpha) on reverse KLD
    reverse_num_samples: int = 256


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax's ``chain(add_decayed_weights(wd), adam(lr))`` over a list of
    tensors, applied in place; ``finite`` (a 0-d bool tensor) masks the
    parameter update only."""

    lr: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor],
               finite: torch.Tensor) -> AdamState:
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        mus, nus = [], []
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu = (1.0 - self.b1) * g + self.b1 * mu
            nu = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(torch.where(finite, -self.lr * u, torch.zeros_like(u)))
            mus.append(mu)
            nus.append(nu)
        return AdamState(count, mus, nus)


def make_optimizer(config: TrainConfig) -> Adam:
    """Adam with torch-style (coupled) weight decay."""
    return Adam(config.lr, config.weight_decay)


def make_train_step(model, config: TrainConfig, optimizer: Adam
                    ) -> Callable[[AdamState, torch.Tensor],
                                  Tuple[AdamState, torch.Tensor]]:
    """One batch's update of ``model``'s parameters, in place:
    ``step(opt_state, batch) -> (opt_state, loss)``.  The loss is
    ``alpha * forward_kld``; a non-finite loss leaves the parameters where
    they were and still advances the optimizer."""
    if config.alpha < 1.0:
        raise NotImplementedError(
            "the reverse-KLD term needs flows/targets.py: ROADMAP queue 1 "
            "item 9")
    params = [p for p in model.parameters()]

    def step(opt_state: AdamState, batch: torch.Tensor):
        loss = config.alpha * model.forward_kld(batch)
        grads = torch.autograd.grad(loss, params)
        finite = torch.isfinite(loss)
        grads = [torch.where(finite, torch.nan_to_num(g), torch.zeros_like(g))
                 for g in grads]
        opt_state = optimizer.update(grads, opt_state, params, finite)
        return opt_state, loss.detach()

    return step


def train(model, data: torch.Tensor, config: TrainConfig,
          generator: torch.Generator,
          opt_state: Optional[AdamState] = None,
          epoch_callback: Optional[Callable[[int, float], None]] = None):
    """``config.epochs`` epochs over ``data`` (M, dim), on its device.

    Returns ``(params, opt_state, loss_history, loss_epoch)``: the model's
    named parameters (trained in place), the optimizer state, the loss of
    every batch and the mean finite loss of every epoch.  Losses stay on
    the device during an epoch and come to the host once at its end.
    """
    optimizer = make_optimizer(config)
    if opt_state is None:
        opt_state = optimizer.init(list(model.parameters()))
    step = make_train_step(model, config, optimizer)
    data = data.to(model.device, model.dtype)
    loss_history: List[float] = []
    loss_epoch: List[float] = []
    for epoch in range(config.epochs):
        batches = epoch_batches(generator, data, config.batch_size)
        losses = []
        for batch in batches:
            opt_state, loss = step(opt_state, batch)
            losses.append(loss)
        losses = torch.stack(losses).cpu() if losses else torch.zeros(0)
        loss_history.extend(losses.tolist())
        finite = losses[torch.isfinite(losses)]
        mean_loss = float(finite.mean()) if finite.numel() else float("nan")
        loss_epoch.append(mean_loss)
        if epoch_callback is not None:
            epoch_callback(epoch, mean_loss)
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())
    return params, opt_state, loss_history, loss_epoch
