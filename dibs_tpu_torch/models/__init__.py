from dibs_tpu_torch.models.graph import ErdosReniDAGDistribution
from dibs_tpu_torch.models.linear_gaussian import BGe, LinearGaussian

__all__ = ["BGe", "LinearGaussian", "ErdosReniDAGDistribution"]
