"""Kernels 1-2 (the ragged expert products) against their roofline over the
traced unit: the least time of every target forward's expert products
(``costs.forward_experts_least_s``: bytes at 3.35 TB/s or FLOPs at
989 TFLOP/s, whichever is longer, with the active experts' weights: every
expert where a forward's rows make that near certain, else the distinct
experts the float32 reference routes its tokens to) over the device time
of the ``ragged_`` kernels in the trace, in %.  Nothing is read when the
trace holds no such kernel or not two of them per MoE layer and forward,
or when a forward's active experts are not known."""
from perfbench.harness.costs import forward_experts_least_s
from perfbench.harness.trace import seconds_by_name

UNIT = "%"
LAYER = "kernels"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or not ctx.traced_forwards:
        return None
    ops = [op for op in ctx.trace.device if "ragged_" in op[2]]
    if len(ops) != 2 * ctx.spec["layers"] * len(ctx.traced_forwards):
        return None
    device_s = sum(seconds_by_name(ops).values())
    if device_s <= 0:
        return None
    return 100.0 * forward_experts_least_s(ctx.traced_forwards, ctx.spec) \
        / device_s
