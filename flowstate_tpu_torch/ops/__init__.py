"""Physics on tensors: box, potentials, system energies, splines."""

from flowstate_tpu_torch.ops.box import (
    Box,
    distance,
    distances_to_all,
    min_image,
    min_image_centered,
    pair_distance_matrix,
    upper_triangle_distances,
    wrap_pbc,
)
from flowstate_tpu_torch.ops.pair_energy import (
    SystemSpec,
    particle_energy_virial,
    pressure,
    total_energy_virial,
)
from flowstate_tpu_torch.ops.potentials import (
    DEFAULT_V0_LIST,
    HARD_CORE_RADIUS,
    double_well_potential,
    double_well_potential_equal,
    gaussian_double_well,
    lennard_jones_energy_virial,
    lennard_jones_force,
    tail_correction_energy_2d,
    tail_correction_pressure_2d,
)
from flowstate_tpu_torch.ops.splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    IDENTITY_DERIVATIVE_CONSTANT,
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
)

__all__ = [
    "Box", "SystemSpec",
    "wrap_pbc", "min_image", "min_image_centered", "distance",
    "distances_to_all", "pair_distance_matrix", "upper_triangle_distances",
    "lennard_jones_energy_virial", "lennard_jones_force",
    "tail_correction_energy_2d", "tail_correction_pressure_2d",
    "double_well_potential", "double_well_potential_equal",
    "gaussian_double_well", "DEFAULT_V0_LIST", "HARD_CORE_RADIUS",
    "total_energy_virial", "particle_energy_virial", "pressure",
    "rational_quadratic_spline", "unconstrained_rational_quadratic_spline",
    "DEFAULT_MIN_BIN_WIDTH", "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_DERIVATIVE", "IDENTITY_DERIVATIVE_CONSTANT",
]
