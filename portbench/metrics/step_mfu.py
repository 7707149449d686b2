"""The whole step's share of the card's float32 peak, in percent: the
frozen operation count of one step (the configuration's ``step_work``,
where it is whole) over the traced window's time a step and 67 TFLOP/s."""
from portbench import layers, workcount


def read(trace, cell):
    flops = layers.step_flops(cell)
    if flops is None or not trace.steps or not trace.device_ops:
        return None
    return 100.0 * flops * trace.steps / (trace.window_s
                                          * workcount.FP32_FLOPS)
