"""device_idle_pct (device): the share of the traced window, in %, in
which no kernel, copy or set ran on the card (one minus the union of the
device's intervals over the window)."""
from spedbench import trace


def read(ctx):
    tl = ctx.timeline
    window = tl.end - tl.start
    if window <= 0 or not tl.device:
        return None
    return 100.0 * (1.0 - trace.busy_ns(tl) / window)
