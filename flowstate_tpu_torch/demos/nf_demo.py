"""NF demo: the reference's NF_demo notebook as a script.

Trains a small circular-spline flow on the configurations of a short MCMC
run and writes the loss curve and the learned density's heatmap data.
"""

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_frequency_heatmap, plot_loss,
)
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.mcmc import (
    init_alternating_wells, init_chain_state, run_moves_batch,
    run_production_batch,
)
from flowstate_tpu_torch.ops import Box, SystemSpec
from flowstate_tpu_torch.training import TrainConfig, train


def main(smoke=False, device="cuda"):
    # smoke=True: a run of seconds on a CPU along the same path
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    pos, _ = init_alternating_wells(10, 3, 0.03)
    state = init_chain_state(spec, torch.as_tensor(pos, device=device), 0,
                             0.65)
    state = run_moves_batch(spec, 1.0, state, 500 if smoke else 5000)
    state, obs = run_production_batch(spec, 1.0, state,
                                      128 if smoke else 1024, 10)
    data = (obs.positions.reshape(-1, 3, 2) - 5.0).reshape(-1, 6)

    g = torch.Generator(device=device).manual_seed(1)
    if smoke:
        model = build_circular_flow(3, 2, 5.0, K=3, hidden_units=32,
                                    num_bins=6, generator=g, device=device)
        config = TrainConfig(batch_size=128, epochs=3, lr=1e-3)
    else:
        model = build_circular_flow(3, 2, 5.0, K=6, hidden_units=64,
                                    num_bins=8, generator=g, device=device)
        config = TrainConfig(batch_size=256, epochs=20, lr=1e-3)
    _, _, _, loss_epoch = train(model, data, config, g)
    plot_loss(loss_epoch, "demo_results/nf_demo")

    with torch.no_grad():
        samples = model.sample(2000 if smoke else 20000, g).cpu().numpy()
    plot_frequency_heatmap(samples.reshape(-1, 3, 2), "demo_results/nf_demo",
                           5.0)
    print("final loss:", loss_epoch[-1])
    return np.asarray(loss_epoch)


if __name__ == "__main__":
    from flowstate_tpu_torch.demos import cli_args
    main(**cli_args())
