"""Kernels a step in the device trace: the launches of the engine's step
(``inference/svgd.py``), which a change that merges or splits kernels
moves by whole counts."""


def read(trace, cell):
    if not trace.kernels or not trace.steps:
        return None
    return len(trace.kernels) / trace.steps
