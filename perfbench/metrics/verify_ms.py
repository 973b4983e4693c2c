"""The target's verify forward of a round in the timed mode
(``SDStats.verify_time`` over rounds, a device sync after each stage), in
ms; without drafting, the decode step's forward."""
UNIT = "ms"
LAYER = "model step"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    if ctx.timed_unit is None:
        return None
    reps = ctx.timed_unit.reports
    rounds = sum(r.stats.rounds for r in reps)
    t = sum(r.stats.verify_time for r in reps)
    return 1e3 * t / rounds if rounds and t > 0 else None
