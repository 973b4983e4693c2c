"""The whole model step's share of the bf16 peak: the target's model FLOPs
for every prompt token prefilled and every output token served in the
window (2 x its parameters active per token, plus attention's
4 x head_dim x heads per visible (query, key) pair), over 989 TFLOP/s x the
window.  Drafting, the EAGLE head, padding and rejected positions are not
counted."""
from perfbench.harness.cells import active_params
from perfbench.harness.costs import mfu_percent

UNIT = "%"
LAYER = "model step"
MOVES = "tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    reqs = [(len(r.prompt), len(r.output)) for r in ctx.window_requests
            if r.output is not None]
    if not reqs or ctx.window_s <= 0:
        return None
    return mfu_percent(reqs, ctx.spec, active_params(ctx.spec), ctx.window_s)
