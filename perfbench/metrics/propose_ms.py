"""The drafter's stage of a round in the timed mode (``SDStats.propose_time``
over rounds, a device sync after each stage), in ms."""
UNIT = "ms"
LAYER = "drafter"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    if ctx.timed_unit is None or not ctx.speculate:
        return None
    reps = ctx.timed_unit.reports
    rounds = sum(r.stats.rounds for r in reps)
    t = sum(r.stats.propose_time for r in reps)
    return 1e3 * t / rounds if rounds and t > 0 else None
