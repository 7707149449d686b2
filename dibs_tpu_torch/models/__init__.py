from dibs_tpu_torch.models.graph import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
    UniformDAGDistributionRejection,
)
from dibs_tpu_torch.models.linear_gaussian import BGe, LinearGaussian
from dibs_tpu_torch.models.nonlinear_gaussian import DenseNonlinearGaussian

__all__ = ["BGe", "LinearGaussian", "DenseNonlinearGaussian",
           "ErdosReniDAGDistribution",
           "ScaleFreeDAGDistribution", "UniformDAGDistributionRejection"]
