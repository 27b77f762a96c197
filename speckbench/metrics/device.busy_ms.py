"""device.busy_ms (ms a call): the time in which an operation ran on the
device, the union of the device operations' intervals over the profiled
calls, a call. Steadier than ``call_ms``, which holds the host's time too."""


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return 1e3 * rec["busy_s"] / rec["profiled_calls"]
