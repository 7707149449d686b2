"""Device milliseconds a step of the MLP likelihood
(``models/nonlinear_gaussian.py`` through ``inference/estimators.py``):
the kernels whose innermost span is ``dibs.likelihood.score`` or
``dibs.likelihood.grad``, the log-joints of the soft and hard samples and
their softmax-weighted autograd back to ``Z`` and ``Theta`` (or #8 where
its gate serves the shape)."""
from portbench import spans

SPANS = {"dibs.likelihood.score", "dibs.likelihood.grad"}


def read(trace, cell):
    log = spans.log()
    return None if log is None else spans.ms_in(trace, log, SPANS)
