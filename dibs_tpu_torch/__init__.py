"""dibs-tpu-torch: the PyTorch and CUDA port of dibs-tpu for NVIDIA Hopper.

Mirrors ``dibs_tpu/`` path for path. Plain tensor code is PyTorch; the three
kernels of the marginal main path (Gumbel graph sampler, BGe determinant
pairs, SE kernel matrix) are hand-written CUDA under ``csrc/``, built with
``nvcc`` at first use. A CUDA tensor goes to the kernel, a CPU tensor to the
kernel's plain PyTorch twin. Imports ``torch`` and never ``jax``.

    from dibs_tpu_torch.inference import MarginalDiBS
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model
    from dibs_tpu_torch.metrics import expected_shd, threshold_metrics
"""

__version__ = "0.1.0"

from dibs_tpu_torch import metrics, target  # noqa: E402,F401
from dibs_tpu_torch.inference import MarginalDiBS, SVGDState  # noqa: E402,F401
from dibs_tpu_torch.kernel import AdditiveFrobeniusSEKernel  # noqa: E402,F401
from dibs_tpu_torch.models import (  # noqa: E402,F401
    BGe,
    ErdosReniDAGDistribution,
    LinearGaussian,
)

__all__ = [
    "MarginalDiBS",
    "SVGDState",
    "AdditiveFrobeniusSEKernel",
    "BGe",
    "LinearGaussian",
    "ErdosReniDAGDistribution",
    "metrics",
    "target",
]
