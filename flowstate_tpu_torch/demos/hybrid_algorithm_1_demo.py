"""Algorithm 1 demo: the reference's hybrid NF-MCMC Algorithm 1 notebook
as a script.

The reference demo's scale: 10 chains, 10,240 training samples, 20
epochs, 20 big moves per chain.
"""

from flowstate_tpu_torch.experiments import algorithm1
from flowstate_tpu_torch.utils.config import algorithm1_config


def main(smoke=False, device="cuda"):
    # smoke=True: a run of seconds on a CPU along the same path
    if smoke:
        config = algorithm1_config(
            experiment_id="a1_demo", output_dir="demo_results",
            num_chains=4, equilibration_steps=300, adjusting_frequency=100,
            initial_training_num_samples=512, sampling_frequency=10,
            batch_size=128, epochs=2, K=3, hidden_units=32, num_bins=8,
            big_move_attempts=5, big_move_interval=20,
            num_samples_for_analysis=512)
    else:
        config = algorithm1_config(
            experiment_id="a1_demo", output_dir="demo_results",
            num_chains=10, equilibration_steps=5000,
            initial_training_num_samples=10240, sampling_frequency=150,
            batch_size=512, epochs=20, K=15, hidden_units=256, num_bins=32,
            big_move_attempts=20, big_move_interval=100,
            num_samples_for_analysis=10000)
    results = algorithm1.run(config, device=device)
    print("Demo finished:", results)
    return results


if __name__ == "__main__":
    from flowstate_tpu_torch.demos import cli_args
    main(**cli_args())
