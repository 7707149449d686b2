"""Device milliseconds a step of the BGe determinant pairs (#2, every
``bge_pairs_*`` kernel: the bits pass and the warp and block routes); its
roofline waits for a count of the parents of the masks a step draws."""
from portbench import layers


def read(trace, cell):
    return layers.ms_per_step(trace, trace.matching("bge_pairs_"))
