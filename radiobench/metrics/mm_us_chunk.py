"""mm_us_chunk: the M&M clock recovery kernel's device time, in
microseconds a chunk.

The mean profiled time of the ``mm_kernel`` events (``mm_fwd``'s
instantiations, real and complex) in the traced window, times the
launches the program counted under ``mm_fwd`` in the window (each replay
of a captured launch counted), over the chunks the window stepped: where
every launch left its event, the events' summed time over the chunks.
The profiler can lose a launch's events in a window (one traced run of
four lost a few: ``device_ops_chunk`` 70.21 against 70.25), so the
events' mean stands for the lost ones rather than the whole reading going
None.  None where the window holds no such event or the program counted
no such launch, as at a program without the kernel.
"""

import re

MM_KERNEL = re.compile(r"\bmm_kernel<")


def read(ctx):
    tr = ctx["trace"]
    n = ctx["launches"].get("mm_fwd", 0)
    if tr is None or not n or not tr.requests:
        return None
    events = [b - a for a, b, name in tr.device if MM_KERNEL.search(name)]
    if not events:
        return None
    chunks = tr.requests * (ctx["mix"]["request_samples"] // ctx["mix"]["chunk"])
    return sum(events) / len(events) * 1e-3 * n / chunks
