"""Wide pass 2 of the fused linear likelihood (``inference/
fused_linear.py``, ``fused_linear_wide_kernel``): its least time by the
frozen count at the (particle, sample) pairs it replayed, which the
program counts (``wide_pass2.replayed`` over ``wide_pass2.calls``), over
its device time, in percent."""
from portbench import spans


def read(trace, cell):
    counts = spans.counters()
    ops = trace.matching("fused_linear_wide_kernel")
    if counts is None or not ops:
        return None
    bound = spans.wide_pass2_bound_s(cell, counts)
    return None if bound is None else 100.0 * bound / trace.seconds(ops)
