"""The window's wall time over the SD rounds it decoded (``SDStats.rounds``),
prefills and admissions included, in ms."""
UNIT = "ms"
LAYER = "SD session"
MOVES = "tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    rounds = sum(r.stats.rounds for r in ctx.window_reports)
    return 1e3 * ctx.window_s / rounds if rounds else None
