"""Algorithm 2 demo: the reference's hybrid NF-MCMC Algorithm 2 notebook
as a script.

The reference demo's scale: 50 on-the-fly training cycles.
"""

from flowstate_tpu_torch.experiments import algorithm2
from flowstate_tpu_torch.utils.config import algorithm2_config


def main(smoke=False, device="cuda"):
    # smoke=True: a run of seconds on a CPU along the same path
    if smoke:
        config = algorithm2_config(
            experiment_id="a2_demo", output_dir="demo_results",
            num_chains=8, equilibration_steps=300, adjusting_frequency=100,
            sampling_frequency=5, initial_training_num_samples=128,
            update_num_samples=128, batch_size=64, K=2, hidden_units=16,
            num_bins=4, num_training_cycles=3, checkpoint_interval=2,
            num_samples_for_analysis=256, num_samples_for_free_energy=64)
    else:
        config = algorithm2_config(
            experiment_id="a2_demo", output_dir="demo_results",
            num_chains=50, equilibration_steps=5000,
            initial_training_num_samples=1000, update_num_samples=1000,
            num_training_cycles=50, checkpoint_interval=10,
            num_samples_for_analysis=10000,
            num_samples_for_free_energy=500)
    results = algorithm2.run(config, device=device)
    print("Demo finished:", results)
    return results


if __name__ == "__main__":
    from flowstate_tpu_torch.demos import cli_args
    main(**cli_args())
