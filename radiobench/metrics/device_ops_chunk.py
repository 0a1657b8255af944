"""device_ops_chunk: device operations (kernels, copies, fills) the
profiler saw in the traced window, a chunk stepped."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    per_request = ctx["mix"]["request_samples"] // ctx["mix"]["chunk"]
    return len(tr.device) / (tr.requests * per_request)
