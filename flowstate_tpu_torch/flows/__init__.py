"""The circular spline flow: splines' nets, couplings, base, model, and
the conditional flow of the blocked moves."""

from flowstate_tpu_torch.flows.convert import params_from_jax, params_to_jax
from flowstate_tpu_torch.flows.core import (
    NormalizingFlow, ParamTree, ScannedLayers, build_circular_flow,
    build_conditional_circular_flow, generate_samples, tree_map,
)
from flowstate_tpu_torch.flows.coupling import (
    CircularSplineCoupling, create_alternating_binary_mask, sum_except_batch,
)
from flowstate_tpu_torch.flows.distributions import UniformParticle
from flowstate_tpu_torch.flows.models import ConditionalNormalizingFlow
from flowstate_tpu_torch.flows.nets import (
    PeriodicFeaturesElementwise, ResidualNet,
)
from flowstate_tpu_torch.flows.targets import (
    CoulombGas, DoubleWellLJ, DWNormal, SimpleLJ,
)

__all__ = [
    "NormalizingFlow", "ParamTree", "ScannedLayers", "build_circular_flow",
    "build_conditional_circular_flow", "ConditionalNormalizingFlow",
    "generate_samples", "tree_map", "CircularSplineCoupling",
    "create_alternating_binary_mask", "sum_except_batch", "UniformParticle",
    "PeriodicFeaturesElementwise", "ResidualNet", "params_from_jax",
    "params_to_jax", "SimpleLJ", "DoubleWellLJ", "DWNormal", "CoulombGas",
]
