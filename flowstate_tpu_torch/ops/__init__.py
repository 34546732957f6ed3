"""Physics on tensors: box, potentials, system energies."""

from flowstate_tpu_torch.ops.box import Box, min_image, wrap_pbc
from flowstate_tpu_torch.ops.pair_energy import (
    SystemSpec,
    particle_energy_virial,
    pressure,
    total_energy_virial,
)
from flowstate_tpu_torch.ops.potentials import (
    HARD_CORE_RADIUS,
    double_well_potential,
    lennard_jones_energy_virial,
    tail_correction_energy_2d,
    tail_correction_pressure_2d,
)

__all__ = [
    "Box", "SystemSpec", "wrap_pbc", "min_image",
    "lennard_jones_energy_virial", "double_well_potential",
    "tail_correction_energy_2d", "tail_correction_pressure_2d",
    "HARD_CORE_RADIUS",
    "total_energy_virial", "particle_energy_virial", "pressure",
]
