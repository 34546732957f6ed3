"""The port's checkpoints (``flowstate_tpu_torch.utils.checkpoint``).

The round trip is bit-equal: the flow, the chain state with its ``seed``
and ``calls`` and the train set come back exactly.  ``latest_checkpoint``
picks what the JAX function picks on the same directory listing.  A
checkpoint's flow, carried by ``params_to_jax`` into the JAX flow, gives
the port's log q within 1e-10 in float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu.utils import checkpoint as jcheckpoint
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.flows import (
    build_circular_flow, params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS
from flowstate_tpu_torch.utils import checkpoint as tcheckpoint

from test_torch_flow import BOUND, DIM, N, flows, inputs, random_tree, to_jax

torch.set_num_threads(1)


def moved_state(seed=7):
    """A chain state after some moves: every field away from its init,
    ``calls`` at 2."""
    spec = tops.SystemSpec.create(N, tops.Box.from_density(N, 0.03),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)
    pos, _ = tmcmc.init_alternating_wells(6, N, 0.03)
    state = tmcmc.init_chain_state(spec, torch.as_tensor(pos), seed, 0.65)
    for _ in range(2):
        state = tmcmc.run_moves_plain(spec, 1.0, state, 25)
    return tmcmc.resync_energy(spec, tmcmc.adjust_displacement(state, 0.5))


def seeded_flow(seed, dtype=torch.float32):
    flow = build_circular_flow(N, DIM, BOUND, K=2, hidden_units=16,
                               num_bins=4, device="cpu").to(dtype)
    tree = random_tree(params_to_jax(flow), seed)
    return params_from_jax(tree, flow)


def test_round_trip_is_bit_equal(tmp_path):
    flow = seeded_flow(1)
    state = moved_state()
    assert state.calls == 2
    rows = np.random.default_rng(2).normal(size=(37, N * DIM))
    path = tcheckpoint.save_checkpoint(
        str(tmp_path / "checkpoints"), 12,
        tcheckpoint.experiment_tree(flow, state, rows),
        metadata={"cycle": 12, "train_set_size": 37})
    assert os.path.basename(path) == "step_00000012"
    assert sorted(os.listdir(path)) == ["metadata.json", "tree.pt"]
    tree, meta = tcheckpoint.restore_checkpoint(path)
    assert meta == {"cycle": 12, "train_set_size": 37}

    fresh = params_from_jax(tree["flow"], seeded_flow(3))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(fresh)),
                    jax.tree_util.tree_leaves(params_to_jax(flow))):
        np.testing.assert_array_equal(a, b)
    back = tcheckpoint.chain_state_from_tree(tree["chains"], "cpu")
    for f in TENSOR_FIELDS:
        got, want = getattr(back, f), getattr(state, f)
        assert got.dtype == want.dtype
        assert torch.equal(got, want) or (
            torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got[~torch.isnan(got)],
                            want[~torch.isnan(want)])), f
    assert (back.seed, back.calls) == (state.seed, state.calls) == (7, 2)
    np.testing.assert_array_equal(tree["train_set"].numpy(),
                                  rows.astype(np.float32))


def test_restored_calls_continue_the_stream(tmp_path):
    """A restored state draws what the saved one would: its moves equal
    the moves the original state makes next."""
    spec = tops.SystemSpec.create(N, tops.Box.from_density(N, 0.03),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)
    state = moved_state(8)
    path = tcheckpoint.save_checkpoint(
        str(tmp_path), 1, {"chains": tcheckpoint.chain_state_tree(state)})
    back = tcheckpoint.chain_state_from_tree(
        tcheckpoint.restore_checkpoint(path)[0]["chains"], "cpu")
    a = tmcmc.run_moves_plain(spec, 1.0, state, 30)
    b = tmcmc.run_moves_plain(spec, 1.0, back, 30)
    assert torch.equal(a.positions, b.positions)
    assert a.calls == b.calls == 3


def test_save_replaces_a_step_and_leaves_no_temporary(tmp_path):
    d = str(tmp_path)
    tcheckpoint.save_checkpoint(d, 4, {"x": torch.zeros(2)})
    tcheckpoint.save_checkpoint(d, 4, {"x": torch.ones(2)}, {"cycle": 4})
    assert os.listdir(d) == ["step_00000004"]
    tree, meta = tcheckpoint.restore_checkpoint(os.path.join(
        d, "step_00000004"))
    assert torch.equal(tree["x"], torch.ones(2)) and meta == {"cycle": 4}


@pytest.mark.parametrize("names", [
    [],
    ["step_00000004"],
    ["step_00000004", "step_00000010", "step_00000007"],
    ["step_00000004", "step_abc", "step_", "other", "step_00000009.tmp"],
    ["step_12", "step_00000011"],
    None,
])
def test_latest_checkpoint_matches_jax(tmp_path, names):
    d = tmp_path / "checkpoints"
    if names is not None:
        d.mkdir()
        for name in names:
            (d / name).mkdir()
    want = jcheckpoint.latest_checkpoint(str(d))
    assert tcheckpoint.latest_checkpoint(str(d)) == want


def test_checkpoint_flow_carried_into_jax_gives_the_same_log_q(tmp_path):
    x = inputs(9)
    with jax.enable_x64(True):
        jm, _, tm, _ = flows(3, 120)
        path = tcheckpoint.save_checkpoint(
            str(tmp_path), 3, {"flow": tcheckpoint.flow_tree(tm)})
        restored = build_circular_flow(N, DIM, BOUND, K=3, hidden_units=16,
                                       num_bins=4, device="cpu").double()
        params_from_jax(tcheckpoint.restore_checkpoint(path)[0]["flow"],
                        restored)
        jlp = np.asarray(jm.log_prob(to_jax(params_to_jax(restored)),
                                     jnp.asarray(x)))
    with torch.no_grad():
        tlp = tm.log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(tlp, jlp, rtol=1e-10, atol=1e-10)
