"""Experiments.  Run one as a module, e.g.
``python -m flowstate_tpu_torch.experiments.mcmc_only``."""
