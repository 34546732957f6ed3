"""The port's multi-device layer (``flowstate_tpu_torch.parallel``, the
replica-sharded swap and ``flowstate_tpu_torch/entry.py``) on the CPU.

Without a process group: the plain engine at a chain offset moves its
rows of the unsharded run bit for bit, the move kernel's launch carries
the offset, ``shard_chain_state`` takes whole rows and refuses a count
the ranks do not divide, and the CUDA paths raise without a card.

Over gloo, 2 and 4 ranks spawned by ``parallel.run_ranks`` from the
package's own step functions (one spawn a world size, shared by the
cases; each spawn has its time limit, and a rank past it is killed and
fails the case): sharded production, MALA and HMC bit-equal to the
unsharded port; ``psum_counter`` and ``all_gather_samples``; the
data-parallel step against the port's single step and JAX's
data-parallel step on a 4-device mesh of the virtual CPUs (loss rtol
1e-5, parameters atol 2e-4: float32 sums in another order), and with the
reverse term (finite, equal on every rank); PT with the replicas over 2
ranks, moves and swap bit-equal to the unsharded port and the swap to
JAX's on the same uniforms; ``entry()`` against JAX's, and the dry run on
1 and 2 ranks.  These mirror ``tests/test_parallel.py``.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowstate_tpu import flows as jflows
from flowstate_tpu import mcmc as jmcmc
from flowstate_tpu import ops as jops
from flowstate_tpu.parallel import (
    make_chain_mesh as jax_mesh, make_data_parallel_train_step as jax_dp,
    shard_batch as jax_shard_batch,
)
from flowstate_tpu.training import (
    TrainConfig as JTrainConfig, TrainState as JTrainState,
    make_optimizer as jax_optimizer,
)
from flowstate_tpu_torch import entry as tentry
from flowstate_tpu_torch import mcmc as tmcmc
from flowstate_tpu_torch import ops as tops
from flowstate_tpu_torch.flows import (
    build_circular_flow, params_from_jax, params_to_jax,
)
from flowstate_tpu_torch.flows.targets import SimpleLJ
from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
from flowstate_tpu_torch.mcmc.state import TENSOR_FIELDS
from flowstate_tpu_torch.parallel import (
    ChainMesh, initialize_distributed, run_ranks, shard_chain_state,
    shard_rows,
)
from flowstate_tpu_torch.training import (
    TrainConfig, make_optimizer, make_train_step,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240.0
CHAINS = 8
MOVES = 30
FLOW = dict(K=2, hidden_units=16, num_bins=4, num_blocks=1)
BATCH = 16
R, W = 4, 3            # PT: replicas (over 2 ranks) and walkers
# the move kernel's contract leaves the virial NaN after local moves
STATE_FIELDS = ("positions", "energy", "max_disp", "attempts", "accepts")


def spec():
    return tops.SystemSpec.create(3, tops.Box.from_density(3, 0.03, 1.0),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)


def whole_state(seed=0, max_disp=0.65):
    pos, _ = tmcmc.init_alternating_wells(CHAINS, 3, 0.03)
    return tmcmc.init_chain_state(spec(), torch.as_tensor(pos), seed,
                                  max_disp)


def perturbed_tree():
    """A numpy tree of the test flow's JAX layout, 0.2 away from the
    identity init (as tests/test_parallel.py perturbs it)."""
    jm = jflows.build_circular_flow(3, 2, 5.0, **FLOW)
    rng = np.random.default_rng(42)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rng.normal(size=np.shape(a))
                   ).astype(np.float32), jm.init_params(jax.random.key(0)))


def torch_flow(tree, target=None):
    flow = build_circular_flow(3, 2, 5.0, **FLOW, target=target,
                               device="cpu")
    return params_from_jax(tree, flow)


def batch():
    return np.random.default_rng(1).uniform(-5.0, 5.0, (BATCH, 6)).astype(
        np.float32)


def pt_inputs():
    """The port's replica-major PT state (base positions jittered, energies
    drawn so that some swaps pass), its ladder and two uniform tables."""
    lx = spec().box.size_x
    rng = np.random.default_rng(5)
    base = np.array([[lx / 4, lx / 2], [lx / 4 + 1.1, lx / 2],
                     [lx / 4 - 0.6, lx / 2 + 0.9]], dtype=np.float32)
    pos = base[None, None] + rng.uniform(-0.05, 0.05, (R, W, 3, 2)).astype(
        np.float32)
    state = tmcmc.init_tempered_state(spec(), torch.as_tensor(pos), 6, 0.65)
    state = state.replace(energy=torch.as_tensor(
        rng.normal(-25.0, 4.0, R * W).astype(np.float32)))
    betas = tmcmc.temperature_ladder(1.0, 8.0, R, device="cpu")
    us = [np.random.default_rng(9 + p).random((R, W), dtype=np.float32)
          for p in (0, 1)]
    us[1][1] = 1e-6    # parity 1's pair (1, 2), across the ranks, swaps
    return state, betas, [torch.as_tensor(u) for u in us]


def alpha_half():
    return TrainConfig(batch_size=BATCH, epochs=1, lr=1e-3, alpha=0.5,
                       reverse_num_samples=BATCH)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('gloo4')}/init"
    target = SimpleLJ(dim=6, n_particles=3, temperature=1.0, bound=5.0)
    return run_ranks([
        (tentry.production_step, (spec(), whole_state(), 1.0, MOVES)),
        (tentry.collectives_step, (torch.arange(8),)),
        (tentry.train_step, (torch_flow(perturbed_tree()),
                             TrainConfig(batch_size=BATCH, epochs=1,
                                         lr=1e-3),
                             torch.as_tensor(batch()))),
        (tentry.train_step, (torch_flow(perturbed_tree(), target),
                             alpha_half(), torch.as_tensor(batch()), 3)),
    ], 4, "cpu", init, SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('gloo2')}/init"
    state, betas, us = pt_inputs()
    return run_ranks([
        (tentry.production_step, (spec(), whole_state(), 1.0, MOVES)),
        (tentry.pt_step, (spec(), betas, state, 5, 0, us[0])),
        (tentry.pt_step, (spec(), betas, state, 5, 1, us[1])),
        (tentry.production_step, (spec(), whole_state(7, 0.02), 1.0, 25,
                                  "mala")),
        (functools.partial(tentry.production_step, num_leapfrog=5),
         (spec(), whole_state(11, 0.02), 1.0, 15, "hmc")),
    ], 2, "cpu", init, SPAWN_TIMEOUT)


def joined(results, index, field, part=None):
    """A field of every rank's result of call ``index`` (or of its
    ``part``), in rank order."""
    return torch.cat([(rank[index] if part is None else rank[index][part])
                      [field] for rank in results])


def assert_shards_equal(results, index, ref, fields=STATE_FIELDS,
                        part=None):
    """Every rank's shard, joined, equals the unsharded ``ref`` bit for
    bit, and each shard names its rows of the run."""
    for f in fields:
        assert torch.equal(joined(results, index, f, part),
                           getattr(ref, f)), f
    total = ref.positions.shape[0]
    for r, rank in enumerate(results):
        shard = rank[index] if part is None else rank[index][part]
        assert shard["chain_offset"] == r * total // len(results)
        assert shard["total_chains"] == total


# ---------------------------------------------------------------------------
# without a process group


@pytest.mark.parametrize("offset,rows", [(0, 8), (0, 4), (4, 4), (6, 2)])
def test_plain_engine_at_an_offset_moves_its_rows_of_the_whole_run(
        offset, rows):
    whole = whole_state()
    ref = cm.run_moves_plain(spec(), 1.0, whole, 40)
    part = whole.replace(**{f: getattr(whole, f)[offset:offset + rows]
                            for f in TENSOR_FIELDS},
                         chain_offset=offset, total_chains=CHAINS)
    out = cm.run_moves_plain(spec(), 1.0, part, 40)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(out, f),
                           getattr(ref, f)[offset:offset + rows]), f
    assert (out.chain_offset, out.total_chains) == (offset, CHAINS)
    with pytest.raises(ValueError, match="not rows of a run"):
        cm.run_moves_plain(spec(), 1.0, part.replace(total_chains=offset), 5)


def test_kernel_launch_params_carry_the_chain_offset():
    """The wrapper takes seed, calls and chain offset from the state into
    ``MoveParams`` (the struct is held field by field against the CUDA
    source in test_torch_pair_kernel.py), and the kernel keys chain c on
    ``chain_offset + c`` in unsigned 32-bit arithmetic."""
    s = whole_state(seed=2 ** 33 + 5)
    p = cm._params(spec(), 1.0, s, 10, False)
    assert (p.chain_offset, p.seed, p.calls, p.num_chains) == (0, 5, 0, 8)
    shard = s.replace(chain_offset=2 ** 31 - 3, calls=7)
    p = cm._params(spec(), 1.0, shard, 10, False)
    assert (p.chain_offset, p.calls) == (2 ** 31 - 3, 7)
    assert cm._params(spec(), 1.0, s.replace(chain_offset=2 ** 32 + 1), 10,
                      False).chain_offset == 1
    with open(os.path.join(REPO, "flowstate_tpu_torch", "csrc",
                           "metropolis_moves.cu")) as f:
        src = f.read()
    assert "unsigned int chain_offset;" in src
    assert ("make_uint2(P.seed, P.chain_offset + (unsigned int)c)"
            in src)


def test_shard_chain_state_takes_whole_rows_and_refuses_a_remainder():
    whole = whole_state()
    shard = shard_chain_state(whole, ChainMesh(1, 4, torch.device("cpu")))
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(shard, f), getattr(whole, f)[2:4]), f
    assert (shard.chain_offset, shard.total_chains) == (2, CHAINS)
    # a shard shards further from its own offset
    again = shard_chain_state(shard, ChainMesh(1, 2, torch.device("cpu")))
    assert (again.chain_offset, again.total_chains) == (3, CHAINS)
    assert shard_rows(12, ChainMesh(2, 3, torch.device("cpu"))) == slice(8, 12)
    with pytest.raises(ValueError, match="do not split"):
        shard_rows(6, ChainMesh(0, 4, torch.device("cpu")))


def test_cuda_paths_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="card"):
        initialize_distributed(f"file://{tmp_path}/init", 1, 0, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="cards"):
        run_ranks([], 1, "cuda")


# ---------------------------------------------------------------------------
# over gloo


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_production_matches_unsharded(world, world2, world4):
    results = {2: world2, 4: world4}[world]
    ref = cm.run_moves_plain(spec(), 1.0, whole_state(), MOVES)
    assert_shards_equal(results, 0, ref)


def test_psum_counter_and_all_gather(world4):
    for rank in world4:
        assert int(rank[1]["psum"]) == 28
        assert torch.equal(rank[1]["gathered"], torch.arange(8))


def test_data_parallel_step_matches_single_step_and_jax(world4):
    tree, x = perturbed_tree(), batch()
    config = TrainConfig(batch_size=BATCH, epochs=1, lr=1e-3)
    single = torch_flow(tree)
    opt = make_optimizer(config)
    _, loss1 = make_train_step(single, config, opt)(
        opt.init(list(single.parameters())), torch.as_tensor(x))
    ref = jax.tree_util.tree_leaves(params_to_jax(single))

    jm = jflows.build_circular_flow(3, 2, 5.0, **FLOW)
    jcfg = JTrainConfig(batch_size=BATCH, epochs=1, lr=1e-3)
    jopt = jax_optimizer(jcfg)
    mesh = jax_mesh(n_devices=4)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate, jloss = jax_dp(jm, jcfg, jopt, mesh)(
        JTrainState(jparams, jopt.init(jparams), jax.random.key(2)),
        jax_shard_batch(jnp.asarray(x), mesh))
    jleaves = jax.tree_util.tree_leaves(jstate.params)

    for rank in world4:
        loss, = rank[2]["losses"].tolist()
        np.testing.assert_allclose(loss, float(loss1), rtol=1e-5)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        leaves = jax.tree_util.tree_leaves(rank[2]["params"])
        for a, b, c in zip(leaves, ref, jleaves):
            np.testing.assert_allclose(a, b, atol=2e-4)
            np.testing.assert_allclose(a, np.asarray(c), atol=2e-4)
        for a, b in zip(leaves, jax.tree_util.tree_leaves(
                world4[0][2]["params"])):
            np.testing.assert_array_equal(a, b)   # one update on every rank


def test_data_parallel_step_with_reverse_term_keeps_ranks_equal(world4):
    """At alpha = 0.5 each rank draws its own base points, so only the
    loss's finiteness and the ranks' agreement are held."""
    start = jax.tree_util.tree_leaves(perturbed_tree())
    first = jax.tree_util.tree_leaves(world4[0][3]["params"])
    assert any(not np.array_equal(a, b) for a, b in zip(first, start))
    for rank in world4:
        assert torch.isfinite(rank[3]["losses"]).all()
        for a, b in zip(jax.tree_util.tree_leaves(rank[3]["params"]), first):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("parity", [0, 1])
def test_replica_sharded_pt_matches_port_and_jax(world2, parity):
    """Replicas 0-1 on rank 0 and 2-3 on rank 1: parity 1 pairs (1, 2)
    across the ranks.  The moves (one beta per chain, at the shard's
    chain offset) and the swap are bit-equal to the unsharded port, and
    the swap to JAX's on the same state and uniforms."""
    state, betas, us = pt_inputs()
    moved = tmcmc.run_tempered_moves(spec(), betas, state, 5)
    ref = tmcmc.swap_replicas(betas, moved, None, parity, u=us[parity])
    index = 1 + parity
    assert_shards_equal(world2, index, ref.state, part="state",
                        fields=("positions", "energy", "accepts",
                                "attempts"))
    accepted = torch.cat([rank[index]["accepted"] for rank in world2])
    assert torch.equal(accepted, ref.accepted)
    assert 0 < int(accepted.sum()) < accepted.numel()
    if parity == 1:
        assert bool(accepted[1:3].all())     # the pair across the ranks
    assert torch.equal(
        torch.cat([rank[index]["edge_attempted"] for rank in world2]),
        ref.edge_attempted)

    js = jmcmc.init_tempered_state(
        jops_spec(), jnp.asarray(moved.positions.reshape(R, W, 3, 2).numpy()),
        jax.random.key(0), 0.65)
    js = js._replace(energy=jnp.asarray(moved.energy.reshape(R, W).numpy()),
                     virial=jnp.asarray(moved.virial.reshape(R, W).numpy()))
    jres = jmcmc.swap_replicas(jnp.asarray(betas.numpy()), js, None, parity,
                               u=jnp.asarray(us[parity].numpy()))
    np.testing.assert_array_equal(accepted.numpy(), np.asarray(jres.accepted))
    for f in ("positions", "energy", "virial"):
        np.testing.assert_array_equal(
            joined(world2, index, f, "state").reshape(
                np.asarray(getattr(jres.state, f)).shape).numpy(),
            np.asarray(getattr(jres.state, f)))


def jops_spec():
    return jops.SystemSpec.create(3, jops.Box.from_density(3, 0.03, 1.0),
                                  num_wells=2, V0_list=(-10.0, -10.5),
                                  r0=1.2, k=15.0)


@pytest.mark.parametrize("sampler,index", [("mala", 3), ("hmc", 4)])
def test_sharded_mala_and_hmc_match_unsharded(world2, sampler, index):
    if sampler == "mala":
        ref = tmcmc.run_mala(spec(), 1.0, whole_state(7, 0.02), 25)
    else:
        ref = tmcmc.run_hmc(spec(), 1.0, whole_state(11, 0.02), 15,
                            num_leapfrog=5)
    assert int(ref.accepts.sum()) > 0
    assert_shards_equal(world2, index, ref, STATE_FIELDS + ("virial",))


def test_entry_matches_jax_entry():
    """At the entry's identity init the loss is 0 up to float32 rounding
    in both packages (a few 1e-6, which a relative tolerance cannot
    hold), so the losses are compared at rtol 1e-5 on JAX's entry weights
    moved by N(0, 0.05), carried across."""
    spec_ = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(graft)
    jfn, (jparams, jbatch) = graft.entry()
    fn, (model, tbatch) = tentry.entry("cpu")
    assert tbatch.shape == (512, 6)
    with torch.no_grad():
        assert abs(float(fn(model, tbatch))) < 1e-5
    assert abs(float(jax.jit(jfn)(jparams, jbatch))) < 1e-5
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))
                   ).astype(np.float32), jparams)
    jloss = float(jax.jit(jfn)(jax.tree_util.tree_map(jnp.asarray, tree),
                               jbatch))
    with torch.no_grad():
        loss = float(fn(params_from_jax(tree, model),
                        torch.as_tensor(np.array(jbatch))))
    assert abs(jloss) > 1e-2
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


@pytest.mark.parametrize("ranks", [1, 2])
def test_dryrun_multichip_on_gloo_ranks(tmp_path, ranks):
    summaries = tentry.dryrun_multichip(
        ranks, "cpu", init_method=f"file://{tmp_path}/init",
        timeout=SPAWN_TIMEOUT)
    assert [s["rank"] for s in summaries] == list(range(ranks))
    for s in summaries:
        assert s["backend"] == "gloo"
        assert s["ring_path"] == ("local" if ranks == 1 else "p2p")
        assert np.isfinite(s["dp_loss"])
        assert torch.equal(s["fused_loss"], summaries[0]["fused_loss"])
        assert s["accepts"] == summaries[0]["accepts"] > 0
        assert s["k1_launches"] == s["k2_launches"] == 0   # no card here
