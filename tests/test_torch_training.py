"""The port's training (``flowstate_tpu_torch.training``) against the JAX
package's ``make_train_step`` on the same weights and batches, in float64
(JAX inside ``jax.enable_x64``): one step's loss and gradients, ten steps
on ten fixed batches, and a NaN batch, which must leave the parameters
where they were while the optimizer's moments and count advance as optax
advances them.  The mixed loss (``alpha < 1``, with the reverse-KLD term
on the ``DoubleWellLJ`` target) is held the same way on the same base
points: one step's loss, gradients and update, and ten steps at
Algorithm 2's lr and weight decay.  Tolerance: 1e-9 relative, 1e-12
absolute, in float64.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu_torch.flows import params_to_jax, tree_map
from flowstate_tpu_torch.training import (
    Adam, TrainConfig, epoch_batches, make_optimizer, make_train_step, train,
)
from flowstate_tpu_torch.training import data as tdata
from flowstate_tpu.training import data as jdata

from flowstate_tpu_torch.utils.config import algorithm2_config

from test_torch_flow import BOUND, DIM, N, flows
from test_torch_targets import TorchFixedBase, with_target_and_z

# the module, which the package's ``train`` function shadows
jtrain = importlib.import_module("flowstate_tpu.training.train")

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)
CFG = dict(batch_size=16, lr=3e-3, weight_decay=1e-2)


def batches(seed, count, m=16):
    rng = np.random.default_rng(seed)
    return rng.uniform(-BOUND, BOUND, size=(count, m, N * DIM))


def assert_params_equal(tm, jparams):
    ours = jax.tree_util.tree_leaves(params_to_jax(tm))
    theirs = jax.tree_util.tree_leaves(jparams)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def jax_stepper(jm, jp, **cfg):
    cfg = jtrain.TrainConfig(**(cfg or CFG))
    opt = jtrain.make_optimizer(cfg)
    step = jax.jit(jtrain.make_train_step(jm, cfg, opt))
    return step, jtrain.TrainState(jp, opt.init(jp), jax.random.key(0))


def port_stepper(tm):
    cfg = TrainConfig(**CFG)
    opt = make_optimizer(cfg)
    return make_train_step(tm, cfg, opt), opt.init(list(tm.parameters()))


def test_one_step_loss_and_gradients_match_jax():
    batch = batches(1, 1)[0]
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(2, 200)
        jloss, jgrads = jax.value_and_grad(jm.forward_kld)(jp, jnp.asarray(
            batch))
    loss = tm.forward_kld(torch.as_tensor(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = tree_map(lambda p: p.grad.numpy(), tm.layers[0].params.tree())
    ours = jax.tree_util.tree_leaves(grads)
    theirs = jax.tree_util.tree_leaves(jgrads[0])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_ten_steps_match_jax_step_by_step():
    data = batches(2, 10)
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(2, 201)
        jstep, jstate = jax_stepper(jm, jp)
        step, state = port_stepper(tm)
        for b in data:
            jstate, jloss = jstep(jstate, jnp.asarray(b))
            state, loss = step(state, torch.as_tensor(b))
            np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
            assert_params_equal(tm, jstate.params)
    assert state.count == int(jstate.opt_state[-1][0].count) == 10


def test_nan_batch_leaves_params_and_advances_the_optimizer():
    data = batches(3, 3)
    data[1, 4, 2] = np.nan
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(2, 202)
        jstep, jstate = jax_stepper(jm, jp)
        step, state = port_stepper(tm)
        for i, b in enumerate(data):
            before = [p.detach().clone() for p in tm.parameters()]
            jstate, jloss = jstep(jstate, jnp.asarray(b))
            state, loss = step(state, torch.as_tensor(b))
            assert np.isfinite(loss.item()) == (i != 1)
            if i == 1:
                assert all(torch.equal(a, p)
                           for a, p in zip(before, tm.parameters()))
            assert_params_equal(tm, jstate.params)
        assert state.count == 3
        # the moments advanced on the NaN batch (with zero gradients)
        # state.mu is in the order of tm.parameters(); put it in the tree
        mu_of = {id(p): m for p, m in zip(tm.parameters(), state.mu)}
        ours = jax.tree_util.tree_leaves(tree_map(
            lambda p: mu_of[id(p)].numpy(), tm.layers[0].params.tree()))
        theirs = jax.tree_util.tree_leaves(jstate.opt_state[-1][0].mu[0])
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_train_returns_the_jax_bookkeeping():
    with jax.enable_x64(True):
        tm = flows(2, 203)[2].float()
    data = torch.as_tensor(batches(4, 1, m=70)[0], dtype=torch.float32)
    seen = []
    params, opt_state, hist, per_epoch = train(
        tm, data, TrainConfig(batch_size=16, epochs=3, lr=1e-3),
        torch.Generator().manual_seed(0),
        epoch_callback=lambda e, l: seen.append((e, l)))
    assert len(hist) == 3 * 4 and len(per_epoch) == 3
    assert [e for e, _ in seen] == [0, 1, 2]
    assert np.allclose([l for _, l in seen], per_epoch)
    assert np.allclose(per_epoch, [np.mean(hist[i * 4:(i + 1) * 4])
                                   for i in range(3)])
    assert opt_state.count == 12
    assert set(params) == {n for n, _ in tm.named_parameters()}


def test_epoch_batches_drop_the_remainder_and_permute():
    data = torch.arange(70 * 2, dtype=torch.float32).reshape(70, 2)
    out = epoch_batches(torch.Generator().manual_seed(1), data, 16)
    assert out.shape == (4, 16, 2)
    rows = out.reshape(-1, 2)[:, 0] / 2
    assert len(set(rows.tolist())) == 64


@pytest.mark.parametrize("name,args", [
    ("flatten_configs", (np.arange(24.0).reshape(4, 3, 2), 3, 2)),
    ("dedup_subsample", (np.repeat(np.arange(20.0).reshape(10, 2), 2, 0),
                         5, 3)),
    ("sliding_window_update", (np.ones((4, 2)), np.zeros((3, 2)), False,
                               5)),
])
def test_numpy_helpers_match_jax(name, args):
    np.testing.assert_array_equal(getattr(tdata, name)(*args),
                                  getattr(jdata, name)(*args))


@dataclasses.dataclass(frozen=True)
class RecordingAdam(Adam):
    """The port's Adam, keeping each update's gradients."""

    seen: list = dataclasses.field(default_factory=list)

    def update(self, grads, state, params, finite):
        self.seen.append([g.clone() for g in grads])
        return super().update(grads, state, params, finite)


@dataclasses.dataclass(frozen=True)
class JaxFloat64Base:
    """The JAX base drawing as it does, in float64: the base points the
    port replays (``TorchFixedBase``) are then exactly JAX's."""

    base: object

    def sample(self, key, num_samples):
        return self.base.sample(key, num_samples).astype(jnp.float64)

    def log_prob(self, z):
        return self.base.log_prob(z)


def in_tree(tm, tensors):
    """Tensors in the order of ``tm.parameters()`` as numpy leaves in the
    order of the JAX tree."""
    of = {id(p): t for p, t in zip(tm.parameters(), tensors)}
    return jax.tree_util.tree_leaves(tree_map(
        lambda p: of[id(p)].numpy(), tm.layers[0].params.tree()))


def test_mixed_loss_step_matches_jax():
    """One ``alpha = 0.5`` step: the loss, every gradient and the updated
    parameters, on the same batch and the same base points."""
    batch = batches(5, 1)[0]
    z = np.random.default_rng(6).uniform(-BOUND, BOUND, size=(256, N * DIM))
    cfg = dict(CFG, alpha=0.5)
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(2, 205)
        jm, tm = with_target_and_z(jm, tm, z)
        jloss, jgrads = jax.value_and_grad(
            lambda p: 0.5 * jm.forward_kld(p, jnp.asarray(batch))
            + 0.5 * jm.reverse_kld(p, jax.random.key(0), 256)[0])(jp)
        jstep, jstate = jax_stepper(jm, jp, **cfg)
        jstate, jstep_loss = jstep(jstate, jnp.asarray(batch))
    opt = RecordingAdam(cfg["lr"], cfg["weight_decay"])
    step = make_train_step(tm, TrainConfig(**cfg), opt, torch.Generator())
    state, loss = step(opt.init(list(tm.parameters())),
                       torch.as_tensor(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(loss.item(), float(jstep_loss), **TOL)
    ours = in_tree(tm, opt.seen[0])
    theirs = jax.tree_util.tree_leaves(jgrads[0])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert_params_equal(tm, jstate.params)
    assert state.count == 1


def test_ten_mixed_steps_at_the_a2_preset_match_jax():
    """Ten ``alpha = 0.9`` steps at Algorithm 2's lr and weight decay,
    step by step: JAX draws each step's base points from its key, the
    port replays them."""
    data = batches(7, 10)
    a2 = algorithm2_config()
    cfg = dict(batch_size=16, lr=a2.lr, weight_decay=a2.weight_decay,
               alpha=0.9)
    with jax.enable_x64(True):
        jm, jp, tm, _ = flows(2, 206)
        jm, tm = with_target_and_z(jm, tm, np.zeros((0, N * DIM)))
        jm = dataclasses.replace(jm, base=JaxFloat64Base(jm.base.base))
        jstep, jstate = jax_stepper(jm, jp, **cfg)
        # the base points of JAX's steps: its key, split as the step does
        key, zs = jstate.key, []
        for _ in data:
            key, k_loss = jax.random.split(key)
            zs.append(np.asarray(jm.base.sample(k_loss, 256)))
        opt = make_optimizer(TrainConfig(**cfg))
        step = make_train_step(tm, TrainConfig(**cfg), opt,
                               torch.Generator())
        state = opt.init(list(tm.parameters()))
        for b, z in zip(data, zs):
            tm.base = TorchFixedBase(tm.base.base, z)
            jstate, jloss = jstep(jstate, jnp.asarray(b))
            state, loss = step(state, torch.as_tensor(b))
            np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
            assert_params_equal(tm, jstate.params)
    assert state.count == 10


def test_reverse_term_needs_a_generator():
    with jax.enable_x64(True):
        tm = flows(2, 204)[2]
    cfg = TrainConfig(alpha=0.5)
    with pytest.raises(ValueError, match="generator"):
        make_train_step(tm, cfg, make_optimizer(cfg))
