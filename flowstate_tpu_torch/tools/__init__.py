"""Measurement tools.  Run one as a module, e.g.
``python -m flowstate_tpu_torch.tools.n_scaling``."""
