"""Config and logging."""

from flowstate_tpu_torch.utils.config import (
    ExperimentConfig,
    algorithm1_config,
    algorithm2_config,
    mcmc_only_config,
    tempering_config,
)
from flowstate_tpu_torch.utils.logging import MetricsWriter, setup_logger

__all__ = [
    "ExperimentConfig", "algorithm1_config", "algorithm2_config",
    "mcmc_only_config", "tempering_config",
    "setup_logger", "MetricsWriter",
]
