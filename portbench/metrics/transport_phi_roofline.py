"""The fused transport families (#4, ``inference/transport.py``): their
least time by the frozen count over the device time of
``transport_phi_kernel``, in percent."""
from portbench import layers


def read(trace, cell):
    return layers.roofline_pct(trace, cell, "transport_phi",
                               trace.matching("transport_phi_kernel"))
