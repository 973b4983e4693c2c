"""Rows decoded a round, weighted by the tokens each round committed: the
batch an average token was decoded at (``WaveReport.batch`` of each wave,
``StepReport.live`` of each round of a stream)."""
from perfbench.harness.costs import token_weighted

UNIT = "rows"
LAYER = "scheduler"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    live, committed = [], []
    for rep in ctx.window_reports:
        if rep.steps is not None:
            for s in rep.steps:
                if s.live:
                    live.append(s.live)
                    committed.append(s.committed)
        else:
            live.append(rep.batch)
            committed.append(rep.tokens_out)
    return token_weighted(live, committed) if live else None
