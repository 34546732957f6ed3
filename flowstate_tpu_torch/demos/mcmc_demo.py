"""MCMC demo: the reference's MCMC_demo notebook as a script.

A short baseline run of the batched engine (the move kernel on the card)
on the 3-particle LJ double-well system, with the sampled trajectory's
plot data.
"""

from flowstate_tpu_torch.experiments import mcmc_only
from flowstate_tpu_torch.utils.config import mcmc_only_config


def main(smoke=False, device="cuda"):
    # smoke=True: a run of seconds on a CPU along the same path
    scale = 50 if smoke else 1
    config = mcmc_only_config(
        experiment_id="mcmc_demo", output_dir="demo_results",
        num_chains=4 if smoke else 10,
        equilibration_steps=5000 // scale,
        sampling_frequency=150 // scale, adjusting_frequency=5000 // scale)
    # the smoke run's production: 667 samples, not the full run's 6667
    results = mcmc_only.run(config,
                            total_production_steps=(2_000 if smoke
                                                    else 1_000_000),
                            device=device)
    print("Demo finished:", results)
    return results


if __name__ == "__main__":
    from flowstate_tpu_torch.demos import cli_args
    main(**cli_args())
