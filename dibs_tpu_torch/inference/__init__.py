from dibs_tpu_torch.inference.estimators import EstimatorConfig, make_estimators
from dibs_tpu_torch.inference.svgd import DiBS, MarginalDiBS, SVGDState

__all__ = ["DiBS", "MarginalDiBS", "SVGDState", "EstimatorConfig",
           "make_estimators"]
