"""Device milliseconds a step of the score-gradient chain
(``inference/estimators.py``): the kernels whose innermost span is
``dibs.likelihood.grad`` (the REINFORCE ratio, the softmax-weighted
autograd call, the ``d scores -> dZ`` products) or ``dibs.prior.grad``
(autograd through the prior's sampler back to ``Z``, without the nested
``dibs.prior.acyclic``)."""
from portbench import spans


def read(trace, cell):
    log = spans.log()
    return None if log is None else spans.ms_in(
        trace, log, {"dibs.likelihood.grad", "dibs.prior.grad"})
