"""Analysis roots and the port's static conventions.

Port of ``repro.analysis.registry``.  The capture pass finds most roots
in the source: every stage callable handed to ``RoundGraphs.run`` (the
SD round of ``core/spec_decode.py``, the timed extend of
``core/target_efficiency.py``) and the body of every
``with torch.cuda.graph(...)``.  The registry adds what the source cannot
say:

* ``KNOWN_ENTRY_POINTS``: functions a captured round reaches by
  indirection (``self.target.extend_with_hidden``,
  ``self.proposer.propose``, a layer's MoE dispatch, the kernel
  wrappers), analysed as roots of their own so the pass stays exhaustive
  when an intermediate call cannot be resolved.  Each names its
  parameters that are Python values by contract; every other parameter
  holds device tensors.
* ``ALWAYS_STATIC_PARAMS``: parameter names that hold host values by the
  repo's convention (``self``, ``cfg``...) wherever device-ness is
  inferred.
* ``STATIC_RESULT_ATTRS`` / ``STATIC_RESULT_METHODS`` /
  ``STATIC_RESULT_CALLS``: reads whose result is a host value even on a
  device tensor (``x.shape``, ``x.device``, ``x.dim()``, ``len(x)``).

To add a root (docs/analysis_torch.md): a :class:`KnownEntry` with the
module-path suffix, the function's qualname and its host parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Optional, Tuple


@dataclass(frozen=True)
class KnownEntry:
    """One registered analysis root.

    ``module`` is a repo-relative path suffix, ``qualname`` the function's
    dotted name inside the module, ``static`` the parameters that hold
    host values (not seeded as device tensors).
    """
    module: str
    qualname: str
    static: Tuple[str, ...] = ()


#: the kernel wrappers' host parameters (softmax scale, cap, masks, tiles)
_KERNEL_STATIC = ("scale", "logit_cap", "causal", "window", "activation",
                  "bm", "k_lo")

#: Roots that a captured round reaches by indirection.
KNOWN_ENTRY_POINTS: Tuple[KnownEntry, ...] = (
    # the target's surface (models/model.py), reached from every round
    KnownEntry("models/model.py", "Model.extend",
               static=("self", "collect")),
    KnownEntry("models/model.py", "Model.extend_with_hidden",
               static=("self", "collect")),
    KnownEntry("models/model.py", "Model.extend_with_prefetch",
               static=("self", "collect")),
    KnownEntry("models/model.py", "Model.commit",
               static=("self", "collected")),
    KnownEntry("models/model.py", "Model.cache_lengths", static=("self",)),
    # proposers (protocol dispatch from the SDEngine stages)
    KnownEntry("core/proposer.py", "ModelProposer.propose",
               static=("self", "gamma")),
    KnownEntry("core/proposer.py", "ModelProposer.commit",
               static=("self",)),
    KnownEntry("core/proposer.py", "NoneProposer.propose",
               static=("self", "gamma")),
    KnownEntry("core/eagle.py", "EagleProposer.propose",
               static=("self", "gamma")),
    KnownEntry("core/eagle.py", "EagleProposer.commit", static=("self",)),
    KnownEntry("core/prefetch.py", "PrefetchProposer.propose",
               static=("self", "gamma")),
    KnownEntry("core/prefetch.py", "PrefetchProposer.commit",
               static=("self",)),
    # MoE dispatch, reached through the layer loop
    KnownEntry("models/moe.py", "moe_forward",
               static=("cfg", "dispatch", "return_metrics", "mesh",
                       "mesh_layout", "shard")),
    KnownEntry("models/moe.py", "warm_experts", static=("cfg", "mesh")),
    KnownEntry("distributed/collectives.py", "moe_ep_forward",
               static=("cfg", "mesh", "layout", "capacity_factor",
                       "shard")),
    # the round's sampling, sentinel and results
    KnownEntry("core/rejection.py", "rejection_sample",
               static=("temperature",)),
    KnownEntry("core/rejection.py", "sample_from", static=("temperature",)),
    KnownEntry("core/rejection.py", "probs_from_logits",
               static=("temperature",)),
    KnownEntry("serving/faults.py", "logits_finite"),
    KnownEntry("core/graphs.py", "StaticIO.publish", static=("self",)),
    # the kernel wrappers (every launch of a captured round)
    KnownEntry("kernels/gmm/ragged.py", "ragged_gmm",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/gmm/ragged.py", "fused_gate_up",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/gmm/ragged.py", "ragged_moe_ffn",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/gmm/gmm.py", "gmm_capacity", static=_KERNEL_STATIC),
    KnownEntry("kernels/decode_attention/ops.py", "decode_attention",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/decode_attention/ops.py", "decode_attention_partial",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/decode_attention/paged.py", "paged_decode_attention",
               static=_KERNEL_STATIC),
    KnownEntry("kernels/flash_attention/flash_attention.py",
               "flash_attention_btd", static=_KERNEL_STATIC),
)

#: Parameter names that hold host values wherever device-ness is inferred.
#: Where a call site is visible, flow from the site wins.
ALWAYS_STATIC_PARAMS: FrozenSet[str] = frozenset({
    "self", "cls", "cfg", "config", "tcfg", "dcfg", "target_cfg",
})

#: Names that hold host values wherever they appear, as a parameter or a
#: local: the parameters above, and the port's mesh, shard and spec
#: records, tree paths and layer kinds.
HOST_NAMES: FrozenSet[str] = ALWAYS_STATIC_PARAMS | frozenset({
    "shard", "tshard", "mesh", "mesh_layout", "layout", "spec", "specs",
    "path", "kind", "axes", "dim", "keep",
})

#: Attribute reads that are host values even on a device tensor.
STATIC_RESULT_ATTRS: FrozenSet[str] = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "is_meta", "layout",
    "requires_grad", "type", "index",
})

#: Tensor methods whose result is a host value (no sync: metadata).
STATIC_RESULT_METHODS: FrozenSet[str] = frozenset({
    "dim", "size", "numel", "stride", "element_size", "is_contiguous",
    "data_ptr", "get_device", "storage_offset", "nelement",
    "untyped_storage", "keys",
})

#: Calls whose result is a host value whatever their arguments.
STATIC_RESULT_CALLS: FrozenSet[str] = frozenset({
    "len", "isinstance", "issubclass", "hasattr", "getattr", "type",
    "callable", "id", "repr", "range", "torch.device", "torch.finfo",
    "torch.iinfo", "torch.is_tensor", "torch.is_floating_point",
    "torch.Size", "torch.cuda.current_stream", "torch.cuda.is_available",
    "torch.is_grad_enabled", "torch.cuda.current_device",
})

#: The host-side tensor factories: a call of one inside a captured stage
#: copies host data at capture, never again (collective_lint S403).
HOST_TENSOR_FACTORIES: FrozenSet[str] = frozenset({
    "torch.tensor", "torch.as_tensor", "torch.from_numpy",
    "torch.asarray",
})

#: Modules allowed to issue ``torch.distributed`` collectives: the port's
#: helpers, which pass their group explicitly (collective_lint S406).
COLLECTIVE_MODULES: Tuple[str, ...] = ("distributed/collectives.py",)

#: Modules allowed to set the process-global default device or dtype: the
#: launchers (collective_lint S405).
GLOBAL_STATE_MODULES: Tuple[str, ...] = ("launch/serve.py",
                                         "launch/train.py")


def lookup_entry(module_rel: str, qualname: str) -> Optional[KnownEntry]:
    """The registry entry for ``qualname`` in the module whose
    repo-relative path ends with the entry's ``module`` suffix."""
    for e in KNOWN_ENTRY_POINTS:
        if module_rel.endswith(e.module) and e.qualname == qualname:
            return e
    return None
