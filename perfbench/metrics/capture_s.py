"""Seconds set-up spent capturing round graphs
(``RoundGraphs.capture_seconds`` summed after the warm-up unit)."""
UNIT = "s"
LAYER = "round graphs"
MOVES = "setup_s"
SOURCE = "program_span"


def read(ctx):
    return ctx.setup_capture_s
