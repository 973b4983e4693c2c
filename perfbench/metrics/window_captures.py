"""Round keys captured into CUDA graphs during the window
(``session_stats()`` captures): 0 when set-up warmed every key."""
UNIT = "count"
LAYER = "round graphs"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    return ctx.window_captures
