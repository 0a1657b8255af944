"""device_idle: 1 minus the share of the traced window in which an
operation ran on the card (the union of the profiler's device intervals,
overlaps counted once)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
