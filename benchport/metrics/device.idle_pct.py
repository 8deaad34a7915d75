"""device.idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card (the union of the profiler's device intervals),
in percent. Moves `qps`."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
