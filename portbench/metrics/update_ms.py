"""Device milliseconds a step of the optimizer's update (rmsprop over ``Z``
and ``Theta`` and the state's adds, ``inference/optimizers.py``): the
kernels whose innermost span, by the program's span log, is
``dibs.update``."""
from portbench import spans


def read(trace, cell):
    log = spans.log()
    return None if log is None else spans.ms_in(trace, log, {"dibs.update"})
