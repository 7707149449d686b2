"""The Gumbel graph sampler (#1, ``ops/soft_graphs.py``; its bytes bind):
the least time of a step's samples by the frozen count over the device
time of ``gumbel_graphs_kernel``, in percent."""
from portbench import layers


def read(trace, cell):
    return layers.roofline_pct(trace, cell, "gumbel_graphs",
                               trace.matching("gumbel_graphs_kernel"))
