"""Flow training: the mixed loss, Adam with coupled weight decay, NaN-skip.

Port of ``flowstate_tpu/training/train.py``: ``TrainConfig`` (:104),
``make_optimizer`` (:117), ``TrainState`` (:57), ``make_train_step``
(:131) and ``train`` (:168).  The loss is ``alpha * forward_kld + (1 - alpha) * reverse_kld``
(:73-79), each term only where its weight is not zero; the reverse term
draws ``reverse_num_samples`` base points per step from the generator
``train`` is given, the same one that shuffles the epochs.

The JAX step zeroes the gradients of a batch whose loss is not finite;
optax's Adam then still advances its moments and step count, and only
the parameter update is zeroed.  ``torch.optim.Adam`` can do neither
(skipping ``step()`` freezes the count, stepping on zero gradients moves
the parameters by the momentum), so the update is written out here:
``Adam`` follows ``optax.add_decayed_weights`` then ``optax.adam`` (eps
1e-8, bias correction), with the update masked by the loss's finiteness
on the device, so a step needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
)

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


class TrainState(NamedTuple):
    """What a training loop carries, under JAX's field names: the
    parameters, the optimizer's state and ``key``, the ``torch.Generator``
    that takes the place of a JAX key.  The port's step keeps the
    parameters in the flow and the generator with ``train``, so it takes
    and returns only the optimizer's state; this holds the three for code
    written against JAX's."""

    params: Any
    opt_state: Any
    key: Optional[torch.Generator]


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


def make_train_step(model, config: TrainConfig, optimizer: Adam,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[[AdamState, torch.Tensor],
                                  Tuple[AdamState, torch.Tensor]]:
    """One batch's update of ``model``'s parameters, in place:
    ``step(opt_state, batch) -> (opt_state, loss)``.  The loss is
    ``alpha * forward_kld(batch) + (1 - alpha) * reverse_kld``, the
    reverse term's base points drawn from ``generator`` (needed when
    ``alpha < 1``); a non-finite loss leaves the parameters where they
    were and still advances the optimizer."""
    if config.alpha < 1.0 and generator is None:
        raise ValueError("the reverse-KLD term (alpha < 1) needs a "
                         "generator for its base samples")
    params = [p for p in model.parameters()]

    def step(opt_state: AdamState, batch: torch.Tensor):
        loss = None
        if config.alpha > 0.0:
            loss = config.alpha * model.forward_kld(batch)
        if config.alpha < 1.0:
            rkld, _ = model.reverse_kld(config.reverse_num_samples, generator)
            rkld = (1.0 - config.alpha) * rkld
            loss = rkld if loss is None else loss + rkld
        # a parameter the loss does not reach (an AffineConstFlow's shift
        # under the base-free loss) takes a zero gradient, as in JAX
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        finite = torch.isfinite(loss)
        grads = [torch.where(finite, torch.nan_to_num(g), torch.zeros_like(g))
                 for g in grads]
        opt_state = optimizer.update(grads, opt_state, params, finite)
        return opt_state, loss.detach()

    return step


def train_epoch(step, opt_state: AdamState, data: torch.Tensor,
                generator: torch.Generator, batch_size: int
                ) -> Tuple[AdamState, torch.Tensor]:
    """One epoch of ``step`` over ``data`` shuffled by ``generator``;
    returns the optimizer state and the batches' losses, on the device."""
    losses = []
    for batch in epoch_batches(generator, data, batch_size):
        opt_state, loss = step(opt_state, batch)
        losses.append(loss)
    return opt_state, (torch.stack(losses) if losses else data.new_zeros(0))


def train(model, data: torch.Tensor, config: TrainConfig,
          generator: torch.Generator,
          opt_state: Optional[AdamState] = None,
          epoch_callback: Optional[Callable[[int, float], None]] = None):
    """``config.epochs`` epochs over ``data`` (M, dim), on its device.

    ``generator`` (on the model's device) shuffles the epochs and, when
    ``config.alpha < 1``, draws the reverse term's base points.  Returns
    ``(params, opt_state, loss_history, loss_epoch)``: the model's named
    parameters (trained in place), the optimizer state, the loss of every
    batch and the mean finite loss of every epoch.  Losses stay on the
    device during an epoch and come to the host once at its end.
    """
    optimizer = make_optimizer(config)
    if opt_state is None:
        opt_state = optimizer.init(list(model.parameters()))
    step = make_train_step(model, config, optimizer, generator)
    data = data.to(model.device, model.dtype)
    loss_history: List[float] = []
    loss_epoch: List[float] = []
    for epoch in range(config.epochs):
        opt_state, losses = train_epoch(step, opt_state, data, generator,
                                        config.batch_size)
        losses = losses.cpu()
        loss_history.extend(losses.tolist())
        finite = losses[torch.isfinite(losses)]
        mean_loss = float(finite.mean()) if finite.numel() else float("nan")
        loss_epoch.append(mean_loss)
        if epoch_callback is not None:
            epoch_callback(epoch, mean_loss)
    params: Dict[str, torch.Tensor] = dict(model.named_parameters())
    return params, opt_state, loss_history, loss_epoch
