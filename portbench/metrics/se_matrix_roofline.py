"""The SE kernel matrices of the transport (#3, ``kernel.py``; the
symmetric call counted as one triangle): their least time by the frozen
count over the device time of ``se_matrix_kernel`` and its split's
``se_reduce_kernel``, in percent."""
from portbench import layers


def read(trace, cell):
    return layers.roofline_pct(trace, cell, "se_matrix",
                               trace.matching("se_matrix_kernel",
                                              "se_reduce_kernel"))
