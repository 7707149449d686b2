"""The acyclicity prior (``ops/acyclic.py``): the frozen count of the
NOTEARS gradient's power chain over the sampled soft graphs
(``acyclic_grad``) at the card's peak, over the device time of every
kernel launched from a Python frame of ``ops/acyclic.py`` (its products
and its elementwise work), in percent."""
from portbench import layers


def read(trace, cell):
    ops = trace.launched_from("dibs_tpu_torch/ops/acyclic.py")
    if ops is None:
        return None
    return layers.roofline_pct(trace, cell, "acyclic_grad", ops)
