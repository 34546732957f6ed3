"""Config, logging, checkpointing, profiling.

The checkpoint functions load on first use: ``checkpoint`` imports the
flows and the chain state, whose modules open ``profiling``'s spans and so
import this package first.
"""

from flowstate_tpu_torch.utils.config import (
    ExperimentConfig,
    algorithm1_config,
    algorithm2_config,
    mcmc_only_config,
    tempering_config,
)
from flowstate_tpu_torch.utils.logging import (
    MetricsWriter,
    save_params_json,
    setup_logger,
)
from flowstate_tpu_torch.utils.profiling import PhaseTimer, annotate, trace

_CHECKPOINT = ("save_checkpoint", "restore_checkpoint", "latest_checkpoint")

__all__ = [
    "ExperimentConfig", "algorithm1_config", "algorithm2_config",
    "mcmc_only_config", "tempering_config",
    "setup_logger", "MetricsWriter", "save_params_json",
    "save_checkpoint", "restore_checkpoint", "latest_checkpoint",
    "PhaseTimer", "annotate", "trace",
]


def __getattr__(name):
    if name in _CHECKPOINT:
        from flowstate_tpu_torch.utils import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
