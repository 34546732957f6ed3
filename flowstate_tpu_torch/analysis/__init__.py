"""Analysis: well statistics, effective sample size, MBAR, the pair
correlation and the ICL plot style (no matplotlib at import)."""

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
    well_counts_device,
)
from flowstate_tpu_torch.analysis.plots import (
    ICL_COLOR_CYCLE,
    get_icl_heatmap_cmap,
    set_icl_color_cycle,
)
from flowstate_tpu_torch.analysis.rdf import calculate_pair_correlation
from flowstate_tpu_torch.analysis.mbar import (
    mbar_expectation,
    mbar_free_energies,
    mbar_log_weights,
    pt_well_delta_f,
)

__all__ = [
    "classify_particles", "calculate_well_statistics",
    "state_histogram_counts", "average_free_energy", "well_centers",
    "well_counts_device", "calculate_pair_correlation",
    "set_icl_color_cycle", "get_icl_heatmap_cmap", "ICL_COLOR_CYCLE",
    "mbar_free_energies", "mbar_log_weights", "mbar_expectation",
    "pt_well_delta_f",
    "effective_sample_size", "integrated_autocorr_time", "autocorrelation",
    "multichain_ess", "sampling_efficiency",
    "WELL_A", "WELL_B", "OUTSIDE", "STATE_LABELS",
]
