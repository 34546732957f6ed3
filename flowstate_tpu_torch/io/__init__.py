"""Host-side IO: flock-protected results aggregation.

Port of ``flowstate_tpu/io``."""

from flowstate_tpu_torch.io.aggregate import (
    RESULTS_HEADER,
    append_results,
    append_row_locked,
)

__all__ = ["append_results", "append_row_locked", "RESULTS_HEADER"]
