"""device.idle (%): the share of the profiled window in which no operation
ran on the device, 1 - (union of the device operations' intervals) /
(the window's length), over calls made without stage spans; nothing where
the trace holds no device operation."""


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
