"""dibs-tpu-torch: the PyTorch and CUDA port of dibs-tpu for NVIDIA Hopper.

Mirrors ``dibs_tpu/`` path for path. Plain tensor code is PyTorch; the
kernels of the marginal and joint main paths (Gumbel graph sampler, BGe
determinant pairs, SE kernel matrix, and the fused linear-Gaussian and
MLP sample-and-score estimators) are hand-written CUDA under ``csrc/``, built
with ``nvcc`` at first use. Every entry point runs on the card unless it is
given ``device="cpu"``; a CUDA tensor goes to the kernel, a CPU tensor to the
kernel's plain PyTorch twin. Imports ``torch`` and never ``jax``.

    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.target import (make_linear_gaussian_model,
                                       make_linear_gaussian_equivalent_model,
                                       make_nonlinear_gaussian_model)
    from dibs_tpu_torch.metrics import expected_shd, threshold_metrics
"""

__version__ = "0.3.0"

from dibs_tpu_torch import metrics, target  # noqa: E402,F401
from dibs_tpu_torch.inference import (  # noqa: E402,F401
    JointDiBS,
    MarginalDiBS,
    SVGDState,
)
from dibs_tpu_torch.kernel import (  # noqa: E402,F401
    AdditiveFrobeniusSEKernel,
    JointAdditiveFrobeniusSEKernel,
)
from dibs_tpu_torch.models import (  # noqa: E402,F401
    BGe,
    DenseNonlinearGaussian,
    ErdosReniDAGDistribution,
    LinearGaussian,
    ScaleFreeDAGDistribution,
    UniformDAGDistributionRejection,
)

__all__ = [
    "MarginalDiBS",
    "JointDiBS",
    "SVGDState",
    "AdditiveFrobeniusSEKernel",
    "JointAdditiveFrobeniusSEKernel",
    "BGe",
    "LinearGaussian",
    "DenseNonlinearGaussian",
    "ErdosReniDAGDistribution",
    "ScaleFreeDAGDistribution",
    "UniformDAGDistributionRejection",
    "metrics",
    "target",
]
