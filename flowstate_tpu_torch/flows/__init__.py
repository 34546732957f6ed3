"""The circular spline flow: splines' nets, couplings, base, model, and
the conditional flow of the blocked moves."""

from flowstate_tpu_torch.flows.convert import params_from_jax, params_to_jax
from flowstate_tpu_torch.flows.core import (
    NormalizingFlow, ParamLayer, ParamTree, ScannedLayers,
    build_circular_flow, build_conditional_circular_flow, generate_samples,
    tree_map,
)
from flowstate_tpu_torch.flows.coupling import (
    CircularSplineCoupling, CoupledRationalQuadraticSpline,
    create_alternating_binary_mask, create_mid_split_binary_mask,
    create_random_binary_mask, sum_except_batch,
)
from flowstate_tpu_torch.flows.distributions import UniformParticle
from flowstate_tpu_torch.flows.models import ConditionalNormalizingFlow
from flowstate_tpu_torch.flows.nets import (
    MLP, ClampExp, ConstScaleLayer, PeriodicFeaturesCat,
    PeriodicFeaturesElementwise, ResidualNet, TorusEGNN, TransformerNet,
    clamp_exp,
)
from flowstate_tpu_torch.flows.targets import (
    CoulombGas, DoubleWellLJ, DWNormal, SimpleLJ,
)

__all__ = [
    "NormalizingFlow", "ParamLayer", "ParamTree", "ScannedLayers",
    "build_circular_flow", "build_conditional_circular_flow",
    "ConditionalNormalizingFlow", "generate_samples", "tree_map",
    "CircularSplineCoupling", "CoupledRationalQuadraticSpline",
    "create_alternating_binary_mask", "create_mid_split_binary_mask",
    "create_random_binary_mask", "sum_except_batch", "UniformParticle",
    "ResidualNet", "MLP", "TransformerNet", "TorusEGNN",
    "PeriodicFeaturesElementwise", "PeriodicFeaturesCat", "ConstScaleLayer",
    "ClampExp", "clamp_exp", "params_from_jax", "params_to_jax", "SimpleLJ",
    "DoubleWellLJ", "DWNormal", "CoulombGas",
]
