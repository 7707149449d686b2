"""Device milliseconds a step of wide pass 2 of the fused linear
likelihood (``fused_linear_wide_kernel``); its roofline waits for a count
of the samples it replays."""
from portbench import layers


def read(trace, cell):
    return layers.ms_per_step(trace, trace.matching("fused_linear_wide_kernel"))
