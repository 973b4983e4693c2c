"""The allocator's peak over set-up and the window
(``torch.cuda.max_memory_allocated()`` after a reset at set-up), in GiB."""
UNIT = "GiB"
LAYER = "device"
MOVES = "tokens_per_s"
SOURCE = "program_counter"


def read(ctx):
    return ctx.memory_peak_bytes / 2**30 if ctx.memory_peak_bytes else None
