from dibs_tpu_torch.inference.estimators import EstimatorConfig, make_estimators
from dibs_tpu_torch.inference.svgd import DiBS, JointDiBS, MarginalDiBS, SVGDState

__all__ = ["DiBS", "MarginalDiBS", "JointDiBS", "SVGDState",
           "EstimatorConfig", "make_estimators"]
