"""Device time of kernel 3 (paged decode attention, the ``paged_`` kernels
of the trace; the split-KV combine launched after it is not counted) over
the traced unit's rounds, in ms."""
UNIT = "ms"
LAYER = "kernels"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.traced_unit is None:
        return None
    rounds = sum(r.stats.rounds for r in ctx.traced_unit.reports)
    t = sum(e - s for s, e, n in ctx.trace.device if "paged_" in n)
    return 1e3 * t / rounds if rounds and t > 0 else None
