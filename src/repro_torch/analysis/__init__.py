"""Runtime guards of the serving invariants (``analysis/runtime.py``):
``compile_guard``, ``transfer_guard`` and ``sharding_guard``.

The reference's ``repro.analysis`` also holds six static passes over its
source (tracer, Pallas, sharding, PRNG and donation lint, cache keys).
They check JAX and Pallas idioms that the port does not use, and have no
counterpart here (the README's list of what does not port)."""
from repro_torch.analysis.runtime import (CompileGuard, ShardingGuard,
                                          TransferGuard, available,
                                          compile_count, compile_guard,
                                          sharding_guard, transfer_guard)

__all__ = ["compile_guard", "CompileGuard", "compile_count",
           "transfer_guard", "TransferGuard", "available",
           "sharding_guard", "ShardingGuard"]
