"""Share of the traced unit's wall time in which no operation ran on the
device: 1 - (union of the device operations' intervals) / (the unit's
span), in %."""
UNIT = "%"
LAYER = "device"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
