"""The normalizing-flow library: the circular spline flow of the hybrid
runs (splines' nets, couplings, base, model, the conditional flow of the
blocked moves), the dense flow zoo (affine, autoregressive, mixing,
elementary, normalization, periodic and reshape layers, the other bases
and models, the stochastic layers, HAIS, the toy targets and the VAE),
and the image, residual and Lipschitz layers with ``GlowBase`` and
``MultiscaleFlow``: every name of the JAX package's ``flows``."""

from flowstate_tpu_torch.flows.affine import (
    AffineConstFlow, AffineCoupling, AffineCouplingBlock, CCAffineConst,
    MaskedAffineFlow,
)
from flowstate_tpu_torch.flows.autoregressive import (
    MADE, AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline, MaskedAffineAutoregressive,
    MaskedPiecewiseRQSAutoregressive,
)
from flowstate_tpu_torch.flows.base import Composite, Reverse
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
from flowstate_tpu_torch.flows.distributions import (
    AffineGaussian, ClassCondDiagGaussian, DiagGaussian, GaussianMixture,
    GaussianPCA, GlowBase, UniformBase, UniformGaussian, UniformParticle,
)
from flowstate_tpu_torch.flows.elementary import Planar, Radial
from flowstate_tpu_torch.flows.image import (
    ActNormImage, ConvNet2d, ConvResidualNet, GlowBlock,
)
from flowstate_tpu_torch.flows.lipschitz import (
    InducedNormCNN, InducedNormConv2d, InducedNormLinear, InducedNormMLP,
    normalize_u, normalize_v, projmax, vector_norm,
)
from flowstate_tpu_torch.flows.mixing import (
    Invertible1x1Conv, InvertibleAffine, LULinearPermute, Permute,
)
from flowstate_tpu_torch.flows.models import (
    ClassCondFlow, ConditionalNormalizingFlow, ContextAffineCoupling,
    MultiscaleFlow,
)
from flowstate_tpu_torch.flows.nets import (
    MLP, ClampExp, ConstScaleLayer, PeriodicFeaturesCat,
    PeriodicFeaturesElementwise, ResidualNet, TorusEGNN, TransformerNet,
    clamp_exp,
)
from flowstate_tpu_torch.flows.normalization import ActNorm, BatchNorm
from flowstate_tpu_torch.flows.periodic import PeriodicShift, PeriodicWrap
from flowstate_tpu_torch.flows.reshape import Merge, Split, Squeeze
from flowstate_tpu_torch.flows.residual import (
    LipschitzCNN, LipschitzMLP, Residual, asym_squash, batch_jacobian,
    batch_trace, geometric_sample, leaky_elu, lipswish, poisson_sample,
)
from flowstate_tpu_torch.flows.sampling import HAIS
from flowstate_tpu_torch.flows.stochastic import (
    DiagGaussianProposal, HamiltonianMonteCarlo, MetropolisHastings,
)
from flowstate_tpu_torch.flows.targets import (
    CoulombGas, DoubleWellLJ, DWNormal, SimpleLJ,
)
from flowstate_tpu_torch.flows.toy_targets import (
    CircularGaussianMixture, ConditionalDiagGaussian, ImagePrior,
    LinearInterpolation, RingMixture, Sinusoidal, SinusoidalGap,
    SinusoidalSplit, Smiley, TwoIndependent, TwoModes, TwoMoons,
    rejection_sample,
)
from flowstate_tpu_torch.flows.transforms import LogitTransform, Shift
from flowstate_tpu_torch.flows.vae import (
    ConstDiagGaussian, Dirac, NNBernoulliDecoder, NNDiagGaussian,
    NNDiagGaussianDecoder, NormalizingFlowVAE, UniformEncoder,
)

__all__ = [
    # model
    "NormalizingFlow", "build_circular_flow",
    "build_conditional_circular_flow", "NormalizingFlowVAE",
    "ScannedLayers", "generate_samples", "ConditionalNormalizingFlow",
    "ContextAffineCoupling", "ClassCondFlow", "MultiscaleFlow",
    # residual + image
    "Residual", "LipschitzMLP", "LipschitzCNN", "lipswish",
    "InducedNormLinear", "InducedNormConv2d", "InducedNormMLP",
    "InducedNormCNN", "normalize_u", "normalize_v", "projmax",
    "vector_norm",
    "geometric_sample", "poisson_sample", "batch_jacobian", "batch_trace",
    "leaky_elu", "asym_squash",
    "GlowBlock", "ConvNet2d", "ConvResidualNet", "ActNormImage",
    # the port's parameter containers and the carry-over from JAX
    "ParamLayer", "ParamTree", "tree_map", "params_from_jax",
    "params_to_jax",
    # couplings / splines
    "CircularSplineCoupling", "CoupledRationalQuadraticSpline",
    "create_alternating_binary_mask", "create_mid_split_binary_mask",
    "create_random_binary_mask", "sum_except_batch",
    "Reverse", "Composite",
    # affine family
    "AffineConstFlow", "CCAffineConst", "AffineCoupling", "MaskedAffineFlow",
    "AffineCouplingBlock",
    # autoregressive
    "MADE", "MaskedAffineAutoregressive", "MaskedPiecewiseRQSAutoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    # mixing
    "Permute", "InvertibleAffine", "LULinearPermute", "Invertible1x1Conv",
    # elementary / norm / periodic / reshape
    "Planar", "Radial", "ActNorm", "BatchNorm", "PeriodicWrap",
    "PeriodicShift", "Split", "Merge", "Squeeze",
    # stochastic + sampling
    "MetropolisHastings", "HamiltonianMonteCarlo", "DiagGaussianProposal",
    "HAIS",
    # bases
    "UniformParticle", "UniformBase", "DiagGaussian", "UniformGaussian",
    "GaussianMixture", "ClassCondDiagGaussian", "GlowBase",
    "AffineGaussian", "GaussianPCA",
    # nets
    "ResidualNet", "MLP", "TransformerNet", "TorusEGNN",
    "PeriodicFeaturesElementwise", "PeriodicFeaturesCat",
    "ConstScaleLayer", "ClampExp", "clamp_exp",
    "LogitTransform", "Shift",
    # physics targets
    "SimpleLJ", "DoubleWellLJ", "DWNormal", "CoulombGas",
    # toy targets / priors
    "TwoMoons", "CircularGaussianMixture", "RingMixture", "TwoIndependent",
    "ConditionalDiagGaussian", "TwoModes", "Sinusoidal", "SinusoidalGap",
    "SinusoidalSplit", "Smiley", "ImagePrior", "LinearInterpolation",
    "rejection_sample",
    # vae
    "Dirac", "UniformEncoder", "ConstDiagGaussian", "NNDiagGaussian",
    "NNDiagGaussianDecoder", "NNBernoulliDecoder",
]
