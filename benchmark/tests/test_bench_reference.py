"""The plain reference against the program at small sizes on the CPU:
the flow's log q (both conditioners, float64), the system's energies and
virials, the move kernel's random stream (Philox4x32-10's published
known answers) and the replay of its moves against the program's plain
engine fed with that stream."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.drivers.rounds import load_weights
from benchmark.reference import flow as ref_flow
from benchmark.reference import metropolis as ref_mh
from benchmark.reference.system import System, energy_virial
from benchmark.tests.standin import REPO, tiny_config


def _config(name):
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("net,n", [("residual", 3), ("transformer", 4)])
def test_flow_log_prob_matches_the_program_in_float64(net, n):
    from flowstate_tpu_torch.flows import build_circular_flow

    config = tiny_config("t", n, net)
    f = config["flow"]
    half_box = math.sqrt(n / 0.03) / 2
    model = build_circular_flow(
        n, 2, half_box, K=f["K"], hidden_units=f["hidden_units"],
        num_bins=f["num_bins"], num_blocks=f["n_blocks"], net_type=net,
        device="cpu", dtype=torch.float64)
    tree = weights.tree_map(lambda t: t.double(),
                            weights.make(f, config["init"], 2 * n, 7, "cpu"))
    load_weights(model, tree)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(64, 2 * n, generator=g, dtype=torch.float64) * 2 - 1) * half_box
    with torch.no_grad():
        sample, logq = model.sample_and_log_prob(64, g)
        program = model.log_prob(x)
    ref = ref_flow.log_prob(tree, x, half_box, net, f["hidden_units"],
                            f["num_bins"], f["num_heads"])
    assert torch.allclose(program, ref, rtol=0, atol=1e-9)
    ref_sample = ref_flow.log_prob(tree, sample, half_box, net,
                                   f["hidden_units"], f["num_bins"],
                                   f["num_heads"])
    assert torch.allclose(logq, ref_sample, rtol=0, atol=1e-8)


def test_weights_count_and_layout_match_the_program():
    from flowstate_tpu_torch.flows import build_circular_flow

    config = _config("a1_n3_residual")
    f = config["flow"]
    assert weights.count(f, 6) == config["parameters"] == 5100570
    model = build_circular_flow(3, 2, 5.0, K=f["K"],
                                hidden_units=f["hidden_units"],
                                num_bins=f["num_bins"],
                                num_blocks=f["n_blocks"], device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 5100570
    load_weights(model, weights.make(f, config["init"], 6, 3, "cpu"))


def test_weights_are_a_function_of_the_seed():
    config = tiny_config("t", 3, "residual")
    a = weights.make(config["flow"], config["init"], 6, 5, "cpu")
    b = weights.make(config["flow"], config["init"], 6, 5, "cpu")
    c = weights.make(config["flow"], config["init"], 6, 6, "cpu")
    same = weights.tree_map(torch.equal, a, b)
    assert all(same["net"]["final"].values())
    assert not torch.equal(a["net"]["final"]["w"], c["net"]["final"]["w"])


def test_energies_match_the_program():
    from flowstate_tpu_torch.ops import Box, SystemSpec
    from flowstate_tpu_torch.ops.pair_energy import total_energy_virial

    config = _config("n8_transformer")["system"]
    sys_ = System.from_config(config)
    spec = SystemSpec.create(8, Box.from_density(8, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    g = torch.Generator().manual_seed(2)
    pos = torch.rand(256, 8, 2, generator=g, dtype=torch.float64) * sys_.box
    pos[:64, 1] = pos[:64, 0] + 0.3 * torch.rand(64, 2, generator=g,
                                                 dtype=torch.float64)
    e, w = energy_virial(sys_, pos)
    e_p, w_p = total_energy_virial(spec, pos)
    assert torch.isinf(e).any() and torch.isfinite(e).any()
    assert torch.equal(torch.isinf(e), torch.isinf(e_p))
    finite = torch.isfinite(e)
    assert torch.allclose(e[finite], e_p[finite], rtol=1e-12, atol=1e-10)
    assert torch.allclose(w[finite], w_p[finite], rtol=1e-12, atol=1e-10)


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        assert tuple(int(v) for v in ref_mh.philox4x32_10(ctr, key)) == want


def test_the_draws_follow_the_kernels_particle_index():
    from flowstate_tpu_torch.mcmc.cuda_metropolis import particle_index

    bits = ref_mh.philox4x32_10(
        (np.arange(4096, dtype=np.uint64), 9, 0, 0), (123, 7))[0]
    for n in (3, 8, 1000):
        assert np.array_equal(particle_index(bits, n), bits % np.uint64(n))


@pytest.mark.parametrize("n", [3, 8])
def test_replay_follows_the_program_on_the_kernels_stream(n):
    """The program's plain engine, fed the kernel's stream as tables, in
    float64 against the reference's replay: the same moves to rounding."""
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm
    from flowstate_tpu_torch.mcmc.initialise import init_alternating_wells
    from flowstate_tpu_torch.mcmc.state import init_chain_state
    from flowstate_tpu_torch.ops import Box, SystemSpec

    sys_ = System(n, 0.03, (-10.0, -10.5), 1.2, 15.0, 1.0)
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    pos0, _ = init_alternating_wells(24, n, 0.03, 1.0)
    state = init_chain_state(spec, torch.as_tensor(pos0, dtype=torch.float64),
                             seed=2 ** 32 + 17, initial_max_displacement=0.65)
    state = state.replace(calls=5)
    moves = 60
    chains = np.arange(24)
    p, ux, uy, ua = ref_mh.draws(state.seed & 0xFFFFFFFF, chains, 5, moves, n)
    tables = (torch.as_tensor(p, dtype=torch.int32),
              torch.as_tensor(np.stack([ux, uy], -1), dtype=torch.float32),
              torch.as_tensor(ua, dtype=torch.float32))
    out = cm.run_moves_plain(spec, 1.0, state, moves, tables)
    replayed, tie = ref_mh.replay(sys_, state.seed & 0xFFFFFFFF, chains, 5,
                                  moves, pos0, np.full(24, np.float32(0.65)))
    gap = ref_mh.position_gap(out.positions.numpy(), replayed, sys_.box)
    assert not tie.all()
    assert gap[~tie].max() < 1e-5
    assert ref_mh.position_gap(replayed, pos0, sys_.box).min() > 0
