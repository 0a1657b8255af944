"""device_ms_req: milliseconds of device-busy time (the union of the
profiler's device intervals) a request in the traced window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.requests or not tr.device:
        return None
    return tr.busy_s * 1e3 / tr.requests
