"""Standalone flow trainer on saved NPZ MCMC data.

Port of ``flowstate_tpu/experiments/train_npz.py`` (the reference's
``NF/Normalizing_flow_npz_data.py``): the same CLI, deduplication and
subsampling of the NPZ configurations, the circular-spline flow, forward-KLD
training, ``trained_model.pkl`` in the JAX parameter layout, and the
heatmap and pair-correlation data of the trained flow's samples (their
``*_data.json`` are written with or without matplotlib).

    python -m flowstate_tpu_torch.experiments.train_npz --npz_path D.npz \\
        --output_path out --half_box 5.0 --device cuda
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from flowstate_tpu_torch.analysis.plots import (
    plot_frequency_heatmap, plot_loss, plot_pair_correlation,
)
from flowstate_tpu_torch.analysis.rdf import calculate_pair_correlation
from flowstate_tpu_torch.flows import build_circular_flow
from flowstate_tpu_torch.training import TrainConfig, dedup_subsample, train


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a circular-spline flow on saved NPZ MCMC configs")
    parser.add_argument("--npz_path", type=str, required=True,
                        help="NPZ with 'configs' (T, N, 2) centered coords")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--K", type=int, default=15)
    parser.add_argument("--n_blocks", type=int, default=2)
    parser.add_argument("--hidden_units", type=int, default=256)
    parser.add_argument("--num_bins", type=int, default=32)
    parser.add_argument("--half_box", type=float, required=True)
    parser.add_argument("--num_particles", type=int, default=3)
    parser.add_argument("--num_dim", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval_samples", type=int, default=50000)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    device = torch.device(args.device)
    os.makedirs(args.output_path, exist_ok=True)
    t_start = time.time()

    npz = np.load(args.npz_path)
    configs = (npz[npz.files[0]] if "configs" not in npz.files
               else npz["configs"])
    dim = args.num_particles * args.num_dim
    flat = configs.reshape(len(configs), dim).astype(np.float32)
    data = dedup_subsample(flat, max_samples=args.max_samples,
                           seed=args.seed)
    print(f"training on {len(data)} unique samples "
          f"(from {len(flat)} raw)")

    model = build_circular_flow(
        args.num_particles, args.num_dim, args.half_box, K=args.K,
        hidden_units=args.hidden_units, num_bins=args.num_bins,
        num_blocks=args.n_blocks, generator=_generator(device, args.seed),
        device=device)
    config = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                         lr=args.lr, weight_decay=args.weight_decay)
    _, _, _, loss_epoch = train(model, torch.as_tensor(data, device=device),
                                config, _generator(device, args.seed + 1))
    plot_loss(loss_epoch, args.output_path)
    model.save(os.path.join(args.output_path, "trained_model.pkl"))

    with torch.no_grad():
        samples = model.sample(args.eval_samples,
                               _generator(device, args.seed + 2))
    samples = samples.cpu().numpy().reshape(-1, args.num_particles,
                                            args.num_dim)
    plot_frequency_heatmap(samples, args.output_path, args.half_box)
    r_vals, g_r = calculate_pair_correlation(
        samples[:5000], args.num_particles, args.half_box)
    plot_pair_correlation(r_vals, g_r, args.output_path)

    elapsed = time.time() - t_start
    print(f"done in {elapsed:.1f}s; final loss {loss_epoch[-1]:.4f}")
    return {"final_loss": loss_epoch[-1], "num_samples": len(data),
            "elapsed_s": elapsed}


if __name__ == "__main__":
    main()
