"""Tokens committed per live row and round (``SDStats.generated`` over the
live rows summed across rounds): 1 + the accepted drafts; exactly 1
without drafting, about 1 at an acceptance rate near 0."""
UNIT = "tokens"
LAYER = "SD session"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    gen = sum(r.stats.generated for r in ctx.window_reports)
    rows = sum(r.stats.max_possible / (r.gamma + 1)
               for r in ctx.window_reports)
    return gen / rows if rows else None
