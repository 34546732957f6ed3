"""Experiment drivers: baseline MCMC (Metropolis, MALA, HMC), parallel
tempering, the hybrid algorithms, single runs, sweeps and the NPZ
trainer.  Run one as a module, e.g.
``python -m flowstate_tpu_torch.experiments.mcmc_only``.

Submodules load lazily, so running a driver with ``-m`` does not import
it twice.
"""

import importlib

__all__ = ["mcmc_only", "algorithm1", "algorithm2", "single_run", "sweep",
           "tempering", "train_npz"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(
            f"flowstate_tpu_torch.experiments.{name}")
    raise AttributeError(name)
