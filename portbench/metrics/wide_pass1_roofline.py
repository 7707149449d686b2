"""Wide pass 1 of the fused linear likelihood (``inference/
fused_linear.py``, ``fused_linear_wide_pass1_kernel``): its least time by
the frozen count over its device time, in percent."""
from portbench import layers


def read(trace, cell):
    return layers.roofline_pct(trace, cell, "fused_linear_wide_pass1",
                               trace.matching("fused_linear_wide_pass1_kernel"))
