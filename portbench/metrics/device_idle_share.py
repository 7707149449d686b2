"""The share of the traced window in which no operation ran on the
device, in percent: 100 (1 - busy / window)."""


def read(trace, cell):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
