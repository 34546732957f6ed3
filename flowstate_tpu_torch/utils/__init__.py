"""Config, logging, checkpointing, profiling."""

from flowstate_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
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

__all__ = [
    "ExperimentConfig", "algorithm1_config", "algorithm2_config",
    "mcmc_only_config", "tempering_config",
    "setup_logger", "MetricsWriter", "save_params_json",
    "save_checkpoint", "restore_checkpoint", "latest_checkpoint",
    "PhaseTimer", "annotate", "trace",
]
