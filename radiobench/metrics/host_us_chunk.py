"""host_us_chunk: microseconds of the harness's host-clock span around its
call into ``StreamExecutor.run`` (the request's readback is outside it) a
chunk stepped.  Read in the ``--trace 1`` run from the requests served
before the profiler started, so that the profiler's host cost stays out."""


def read(ctx):
    if not ctx["entry_s"]:
        return None
    per_request = ctx["mix"]["request_samples"] // ctx["mix"]["chunk"]
    return sum(ctx["entry_s"]) * 1e6 / (len(ctx["entry_s"]) * per_request)
