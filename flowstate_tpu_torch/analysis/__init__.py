"""Host-side analysis: well statistics and effective sample size."""

from flowstate_tpu_torch.analysis.ess import (
    autocorrelation,
    effective_sample_size,
    integrated_autocorr_time,
    multichain_ess,
    sampling_efficiency,
)
from flowstate_tpu_torch.analysis.wells import (
    OUTSIDE,
    STATE_LABELS,
    WELL_A,
    WELL_B,
    average_free_energy,
    calculate_well_statistics,
    classify_particles,
    state_histogram_counts,
    well_centers,
)

__all__ = [
    "classify_particles", "calculate_well_statistics",
    "state_histogram_counts", "average_free_energy", "well_centers",
    "effective_sample_size", "integrated_autocorr_time", "autocorrelation",
    "multichain_ess", "sampling_efficiency",
    "WELL_A", "WELL_B", "OUTSIDE", "STATE_LABELS",
]
