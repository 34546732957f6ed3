"""Parallel-tempering demo.

Replica exchange on the 3-particle LJ double well: every walker starts
with all particles in well A (a state plain beta = 1 MCMC never leaves),
and the cold replica recovers the exact free-energy difference through
the hot end of the ladder's crossings.  The full-size run:
``python -m flowstate_tpu_torch.tools.tempering_check``.
"""

import numpy as np
import torch

from flowstate_tpu_torch.analysis.wells import classify_particles
from flowstate_tpu_torch.mcmc import (
    init_tempered_state, run_replica_exchange, temperature_ladder,
)
from flowstate_tpu_torch.ops import Box, SystemSpec


def main(smoke=False, device="cuda"):
    # smoke=True: a run of seconds on a CPU along the same path
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    betas = temperature_ladder(1.0, 10.0, 8, device=device)

    base = np.array([[lx / 4, ly / 2], [lx / 4 + 1.1, ly / 2],
                     [lx / 4 - 0.6, ly / 2 + 0.9]], dtype=np.float32)
    walkers = 8 if smoke else 64
    pos = np.tile(base, (8, walkers, 1, 1))  # replicas x walkers, all in A
    state = init_tempered_state(spec, torch.as_tensor(pos, device=device), 0,
                                0.65)

    rounds = 80 if smoke else 800
    result = run_replica_exchange(
        spec, betas, state, torch.Generator(device=device).manual_seed(1),
        num_rounds=rounds, moves_per_round=10 if smoke else 50)

    cold = result.cold_positions.cpu().numpy()[rounds * 3 // 8:]
    labels = classify_particles(cold.reshape(-1, 3, 2), lx / 2, r0=spec.r0)
    all_a = np.all(labels == 0, axis=-1).sum()
    all_b = np.all(labels == 1, axis=-1).sum()
    df = np.log(max(all_b, 1) / max(all_a, 1))
    print(f"edge swap acceptance: "
          f"{result.edge_acceptance.cpu().numpy().round(3).tolist()}")
    print(f"cold-replica dF = {df:.3f}  (exact quadrature: 1.490)")
    return df


if __name__ == "__main__":
    from flowstate_tpu_torch.demos import cli_args
    main(**cli_args())
