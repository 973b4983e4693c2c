"""Collectives over ``torch.distributed``: the expert-parallel MoE dispatch
(the paper's §3.4 deployment) and the tensor-parallel operators of the
non-expert layers.

Port of ``repro.distributed.collectives``, and of what GSPMD inserts for
the reference around every leaf that ``distributed/sharding.param_spec``
shards.

Tensor parallelism (``Shard`` and the operators below).  Megatron's two
conjugate operators over the ``"model"`` group: ``copy_to`` (*f*: the
identity forward, an all-reduce backward) at a column-parallel input, and
``reduce_from`` (*g*: an all-reduce forward, the identity backward) after
a row-parallel output.  (``torch.distributed.nn.functional.all_reduce``
would all-reduce in the backward too, which on a replicated input
multiplies the gradient by the group size.)  ``gather`` all-gathers a
block along a dim; its backward reduce-scatters when the ranks it
gathered from computed on different rows (an FSDP leaf over the batch
axes) and keeps the rank's own block when they computed the same rows
(a leaf whose shard does not line up with what its layer computes on, or
an activation).  ``split`` is its conjugate.  ``vocab_embed`` is the
vocab-parallel lookup and ``lse_combine`` merges per-rank partial
attention outputs by their log-sum-exp.  At a group of one every operator
is the identity and issues nothing, as GSPMD issues nothing.

Census mode.  Over a ``launch/mesh.CensusMesh`` (the dry-run's: axis
sizes alone, rank 0, no process group) every collective records its
kind, its operand bytes on this rank, its axes and whether a layer of the
stack issued it (``launch/costs.record_collective``), and returns a result
of the right shape without communicating (an all-gather's other blocks
and a reduction's sum are left as they are: the dry-run's tensors are on
the meta device and hold no values).  The EP dispatch's all-to-alls
record the padded slot buffers they send, as issued; its ragged FFN
runs on the stated routing (``launch/costs.stated_group_sizes``).

Expert parallelism (``moe_ep_forward``).  The one-hot dispatch runs every
token through every expert and the ``gmm`` dispatch needs every expert on
one device; this module shards the experts over the mesh's ``"model"`` axis
and moves the routed tokens to them through two all-to-all hops into the
ragged grouped matmul (kernels 1 and 2, ``kernels/gmm/ragged.py``):

  * expert weights: each rank holds ``E / m`` experts, the block of its
    ``"model"`` coordinate (``sharding.shard_params``; a whole leaf is
    sliced here);
  * token rows shard over EVERY rank of the mesh (each of the n ranks
    routes a disjoint slice, padded to an even split), or over the
    ``"model"`` group when the batch is already split over ``"data"``;
  * each rank ranks its (token, k) pairs per destination rank and sends
    the payloads with ``all_to_all_single`` over the ``"model"`` group:
    per-destination slot buffers, not dense (E, C) capacity bins;
  * the receiving rank sorts arrivals by LOCAL expert id and runs the
    ragged kernels with local group sizes; the slots nobody filled sort
    into a trailing group no expert owns, rows past ``sum(sizes)`` the
    kernels never touch and this module zeroes;
  * the return all-to-all brings each pair's expert output home, where it
    is combined against the top-k weights in fp32, and an all-gather hands
    every rank the ``(B, T, d)`` output that the layers downstream read
    (GSPMD inserts this gather implicitly in the reference);
  * a shared expert split over ``"model"`` ("tp" placement) runs on that
    replicated ``(B, T, d)`` input with the tensor-parallel pattern and is
    added after the gather; a whole one ("fsdp" serving) runs on the
    rank's own rows between the hops, so no rank does all of its work.

Every shape comes from ``slots`` alone, and nothing reads the device from
the host, so an EP round is captured in the session's CUDA graphs like
any other (``core/graphs.py``).  ``EP_CALLS`` counts the calls that
really dispatched (a graph replay credits it, as it credits kernel
launches).  Per-layer collective cost: 2 x N·K·d / ep elements a rank on
the mean (``core/perf_model.ep_a2a_bytes``); the drop-free slot buffers
sent are ep times that, each destination's sized for all N_loc·K pairs.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.perf_model import ep_a2a_bytes
from repro_torch.distributed.constraints import resolve_mesh
from repro_torch.distributed.sharding import mesh_coords
from repro_torch.kernels.gmm import ragged
from repro_torch.launch import costs
from repro_torch.launch.mesh import CensusGroup, CensusMesh, mesh_dims
from repro_torch.models.layers import apply_mlp

# expert-parallel forwards that went through the all-to-all dispatch
EP_CALLS = {"moe_ep_forward": 0}


def reset_ep_calls() -> None:
    EP_CALLS["moe_ep_forward"] = 0


def _census(kind: str, x: torch.Tensor, group) -> bool:
    """Record a collective over a census group and return True; False for
    a process group (the caller communicates)."""
    if not isinstance(group, CensusGroup):
        return False
    costs.record_collective(kind, x.numel() * x.element_size(), group.axes,
                            group.in_loop)
    return True


def _rank(group) -> int:
    return 0 if isinstance(group, CensusGroup) else dist.get_rank(group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    if _census("all-gather", inp, group):
        return
    # all_gather_single is all_gather_into_tensor's newer name
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    if _census("all-to-all", inp, group):
        return
    dist.all_to_all_single(out, inp, group=group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (recorded, over a census group)."""
    if not _census("all-reduce", x, group):
        dist.all_reduce(x, group=group)
    return x


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class Shard:
    """This rank's place on a mesh, as the layers read it: the ``"model"``
    group (size ``m``, this rank ``j``), the ``"data"`` group (size ``d``,
    this rank ``di``), the layout, ``batch_axes``, the axes the rows of the
    batch in flight are split over (() when every rank holds them all),
    ``params``, the resolved specs of the params subtree a layer computes
    on (after ``materialize``: only the ``"model"`` blocks it computes on;
    None when it is whole), and ``cache``, its cache's leaf specs (a
    ``sharding.CachePlacement`` layer; None for a whole cache)."""

    def __init__(self, mesh, layout: str = "tp", batch_axes=(),
                 params=None, cache=None, in_stack: bool = False):
        dims, coords = mesh_dims(mesh), mesh_coords(mesh)
        self.mesh, self.layout, self.dims = mesh, layout, dims
        self.m, self.j = dims["model"], coords["model"]
        self.d, self.di = dims.get("data", 1), coords.get("data", 0)
        self.batch_axes = tuple(batch_axes)
        self.params, self.cache = params, cache
        self.in_stack = in_stack

    def replace(self, **kw) -> "Shard":
        args = dict(batch_axes=self.batch_axes, params=self.params,
                    cache=self.cache, in_stack=self.in_stack)
        args.update(kw)
        return Shard(self.mesh, self.layout, **args)

    def with_batch(self, batch_axes) -> "Shard":
        return self.replace(batch_axes=batch_axes)

    def sub(self, *keys) -> "Shard":
        """The same place, its ``params`` specs those of a subtree."""
        specs = self.params
        for k in keys:
            specs = None if specs is None else specs.get(k)
        return self.replace(params=specs)

    def blocked(self, name: str) -> bool:
        """Whether param leaf ``name`` (a "/" path in ``params``) is this
        rank's ``"model"`` block."""
        spec = self.params
        for k in name.split("/"):
            spec = None if spec is None else spec.get(k)
        return spec is not None and "model" in spec

    def cache_split(self, name: str) -> Optional[int]:
        """The dim of cache leaf ``name`` this rank holds a ``"model"``
        block of; None when that leaf is whole over ``"model"``."""
        spec = None if self.cache is None else self.cache.get(name)
        return None if spec is None or "model" not in spec \
            else spec.index("model")

    def group(self, axes):
        """The process group of one axis or a tuple of axes (the whole
        mesh, which is the world, for both); on a census mesh its census
        group, marked as a layer's when this is a layer's place."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if isinstance(self.mesh, CensusMesh):
            return self.mesh.group(axes, in_loop=self.in_stack)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        return dist.group.WORLD

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.dims[a] for a in axes)

    def sums_over(self, axes) -> bool:
        """Whether ranks along ``axes`` computed on different rows, so a
        gradient gathered over them must be summed."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return any(a in self.batch_axes for a in axes)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), group)


def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, xm, group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * per, per).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if _census("reduce-scatter", x, group):
        return _block(x, dim, group, n)
    if dist.get_backend(group) == "nccl":
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=group)
        return out.movedim(0, dim)
    return _block(_all_reduce(x, group), dim, group, n)   # gloo has none


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, sum_grad):
        ctx.args = (dim, group, n, sum_grad)
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        dim, group, n, sum_grad = ctx.args
        dx = (_reduce_scatter(dy, dim, group, n) if sum_grad
              else _block(dy, dim, group, n))
        return dx, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _block(x, dim, group, n)

    @staticmethod
    def backward(ctx, dy):
        dim, group, n = ctx.args
        return _gather_dim(dy, dim, group, n), None, None, None


def copy_to(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """*f*: the identity; its backward all-reduces over ``"model"``."""
    if shard is None or shard.m == 1:
        return x
    return _CopyTo.apply(x, shard.group("model"))


def reduce_from(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """*g*: the all-reduce over ``"model"``; the identity backward."""
    if shard is None or shard.m == 1:
        return x
    return _ReduceFrom.apply(x, shard.group("model"))


def reduce_over(x: torch.Tensor, shard: Optional[Shard], axes
                ) -> torch.Tensor:
    """*g* over any axes: the all-reduce (sum) forward, the identity
    backward (each rank's rows keep their own part of the gradient)."""
    if shard is None or not axes or shard.size(axes) == 1:
        return x
    return _ReduceFrom.apply(x, shard.group(axes))


def gather(x: torch.Tensor, dim: int, shard: Optional[Shard],
           axes="model") -> torch.Tensor:
    """All-gather this rank's block along ``dim`` over ``axes`` (blocks in
    ``NamedSharding`` order).  The backward reduce-scatters when ``axes``
    split the batch (``Shard.sums_over``), else keeps the rank's block."""
    if shard is None or shard.size(axes) == 1:
        return x
    return _Gather.apply(x, dim, shard.group(axes), shard.size(axes),
                         shard.sums_over(axes))


def split(x: torch.Tensor, dim: int, shard: Optional[Shard],
          axes="model") -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; the
    backward all-gathers."""
    if shard is None or shard.size(axes) == 1:
        return x
    return _Split.apply(x, dim, shard.group(axes), shard.size(axes))


def materialize(tree, specs, shard: Shard, keep, path: str = ""):
    """(a params subtree as a layer computes on it, the specs that remain):
    every leaf is all-gathered along each dim its resolved spec (``specs``,
    a tree like ``tree``; None: whole) splits, except a ``"model"`` dim of
    a leaf ``keep(path)`` computes on its block of, which stays in the
    remaining spec."""
    if specs is None:
        return tree, None
    if isinstance(tree, dict):
        out = {k: materialize(v, specs[k], shard, keep,
                              f"{path}/{k}" if path else k)
               for k, v in tree.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(tree, (list, tuple)):
        out = [materialize(v, sp, shard, keep, f"{path}/{i}")
               for i, (v, sp) in enumerate(zip(tree, specs))]
        return [v[0] for v in out], [v[1] for v in out]
    left = []
    for dim, entry in enumerate(specs):
        if entry == "model" and keep(path):
            left.append(entry)
            continue
        if entry is not None:
            tree = gather(tree, dim, shard, entry)
        left.append(None)
    return tree, tuple(left)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                shard: Shard) -> torch.Tensor:
    """Vocab-parallel lookup: ``table`` is this rank's block of V / m rows;
    ids outside it read zeros, and *g* sums the blocks."""
    n = table.shape[0]
    local = ids - shard.j * n
    ok = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)]
    x = torch.where(ok[..., None], x, torch.zeros_like(x))
    return reduce_from(x, shard)


def lse_combine(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge n partial attention outputs (n, ..., D), each normalized over
    its own keys, by their fp32 log-sum-exps (n, ...).  A block with no
    visible key carries lse = -inf and weighs 0; a row no block sees
    comes out 0, never NaN.  fp32 result."""
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)                         # 0 where lse = -inf
    den = w.sum(0)
    num = (w[..., None] * outs.float()).sum(0)
    return num / den.clamp(min=1e-30)[..., None]


def gather_partials(out: torch.Tensor, lse: torch.Tensor,
                    shard: Shard) -> torch.Tensor:
    """All-gather every rank's partial (out, lse) over ``"model"`` and merge
    them (``lse_combine``), in ``out``'s dtype."""
    m, grp = shard.m, shard.group("model")
    outs = _gather_dim(out, 0, grp, m).view((m,) + tuple(out.shape))
    lses = _gather_dim(lse, 0, grp, m).view((m,) + tuple(lse.shape))
    return lse_combine(outs, lses).to(out.dtype)


def _local_experts(w: torch.Tensor, num_experts: int, m: int,
                   j: int) -> torch.Tensor:
    """Rank ``j``'s expert block of a leaf that is whole (E, ...) or
    already sharded (E / m, ...)."""
    e_local = num_experts // m
    if w.shape[0] == e_local:
        return w
    if w.shape[0] != num_experts:
        raise ValueError(f"expert leaf has {w.shape[0]} experts; expected "
                         f"{num_experts} (whole) or {e_local} (sharded)")
    return w[j * e_local:(j + 1) * e_local]


def _ragged_ep_shard(x: torch.Tensor, params: dict, cfg, *, slots: int,
                     m: int, j: int, group, shared: bool) -> torch.Tensor:
    """One rank's part (the reference's shard_map body): route the local
    rows ``x`` (N_loc, d), all-to-all the routed payloads to the ranks
    owning the chosen experts, run the local ragged FFN, all-to-all the
    results back and combine them against the top-k weights.  ``shared``:
    add the shared expert of the local rows (whole weights), run between
    the hops."""
    from repro_torch.models.moe import router_topk

    N, d = x.shape
    K, E = cfg.num_experts_per_tok, cfg.num_experts
    e_local = E // m
    dev = x.device
    w_gate, w_up, w_down = (_local_experts(params[k], E, m, j)
                            for k in ("w_gate", "w_up", "w_down"))

    # 1. route with the replicated router, as the single-device dispatches
    weights, indices, _ = router_topk(params, cfg, x)

    # 2. rank each (token, k) pair within its destination rank
    flat_e = indices.reshape(-1)                            # (N*K,)
    dest = flat_e // e_local
    tok = torch.arange(N, device=dev).repeat_interleave(K)
    onehot = (dest[:, None] == torch.arange(m, device=dev)).to(torch.int32)
    rank = torch.cumsum(onehot, 0) - onehot
    slot = rank.gather(1, dest[:, None])[:, 0].to(torch.int64)
    kept = slot < slots                                     # all True drop-free
    # a dropped pair writes into the spare destination row m, sliced off
    dest_eff = torch.where(kept, dest, torch.full_like(dest, m))
    slot = torch.where(kept, slot, torch.zeros_like(slot))

    # 3. dispatch: payloads and their LOCAL expert id on the destination
    #    (e_local marks an empty slot)
    send = x.new_zeros((m + 1, slots, d))
    send.index_put_((dest_eff, slot), x[tok])
    send_eid = torch.full((m + 1, slots), e_local, dtype=torch.int32,
                          device=dev)
    send_eid.index_put_((dest_eff, slot), (flat_e % e_local).to(torch.int32))
    recv = torch.empty((m, slots, d), dtype=x.dtype, device=dev)
    recv_eid = torch.empty((m, slots), dtype=torch.int32, device=dev)
    _all_to_all(recv, send[:m], group)
    _all_to_all(recv_eid, send_eid[:m], group)

    # 4. the shared expert on the local rows, between the hops
    shared_out = None
    if shared:
        shared_out = apply_mlp(params["shared"], x, cfg.mlp_activation)

    # 5. local ragged FFN: arrivals sorted by local id (stable: source rank,
    #    then slot); group sizes by a scatter-add, which reads nothing back
    xs = recv.reshape(m * slots, d)
    eid = recv_eid.reshape(-1).to(torch.int64)
    order = torch.argsort(eid, stable=True)
    sizes = torch.zeros((e_local + 1,), dtype=torch.int32, device=dev)
    sizes.scatter_add_(0, eid, torch.ones_like(eid, dtype=torch.int32))
    sizes = sizes[:e_local]
    # the meta device (the dry-run) holds no routing: a stated one, under
    # which each of the m ranks sends this one N·K/m of its pairs
    ys = ragged.ragged_moe_ffn(xs[order].contiguous(), w_gate.contiguous(),
                               w_up.contiguous(), w_down.contiguous(),
                               costs.stated_group_sizes(sizes, N * K),
                               activation=cfg.mlp_activation)
    real = torch.arange(m * slots, device=dev) < sizes.sum()
    ys = torch.where(real[:, None], ys, torch.zeros_like(ys)).to(x.dtype)
    back = torch.empty_like(ys).index_copy_(0, order, ys).view(m, slots, d)

    # 6. return hop, then the top-k combine in fp32, each token's K rows in
    #    (token, k) order summed by one reduction (the same bits eager and
    #    replayed; the reference scatter-adds them)
    ret = torch.empty_like(back)
    _all_to_all(ret, back, group)
    gathered = ret[torch.where(kept, dest, torch.zeros_like(dest)), slot]
    wk = weights.reshape(-1) * kept
    out = (gathered.float() * wk[:, None]).view(N, K, d).sum(1).to(x.dtype)
    return out if shared_out is None else out + shared_out


def moe_ep_forward(params: dict, cfg, x: torch.Tensor, *, mesh=None,
                   layout: Optional[str] = None,
                   capacity_factor: Optional[float] = None,
                   shard: Optional[Shard] = None) -> torch.Tensor:
    """(B, T, d) -> (B, T, d) expert-parallel MoE FFN on every rank of
    ``mesh`` (module docstring).  ``capacity_factor=None`` sizes each
    destination's slot buffer to the drop-free worst case N_loc·K, so the
    output equals the single-device ``gmm`` dispatch's; a finite factor
    trades all-to-all volume for drops under skew, pair for pair as the
    reference drops them.  ``shard`` (the model's, scoped to the layer's
    ``ffn``) says whether ``x``'s rows are this data group's alone and
    whether the shared expert is split over ``"model"``; without one the
    rows are every rank's and the shared expert whole.
    With no mesh, or ``E`` not divisible over ``"model"``, this is the
    one-hot dispatch, as in the reference."""
    from repro_torch.models import moe as moe_mod

    mesh, layout = resolve_mesh(mesh, layout)
    dims = None if mesh is None else mesh_dims(mesh)
    if dims is None or "model" not in dims \
            or cfg.num_experts % dims["model"] != 0:
        return moe_mod.moe_forward(params, cfg, x, dispatch="onehot")[0]
    if shard is None:
        shard = Shard(mesh, layout)
    B, T, d = x.shape
    m = dims["model"]
    # rows already split over "data" spread over their model group only
    row_group = "model" if "data" in shard.batch_axes else tuple(dims)
    n_shards = shard.size(row_group)
    K = cfg.num_experts_per_tok
    # row-shard tokens over the group, padded to an even split with zero
    # rows (routed, computed, sliced off)
    xf = x.reshape(B * T, d)
    n_pad = -(-(B * T) // n_shards) * n_shards
    n_local = n_pad // n_shards
    if capacity_factor is None:
        slots = n_local * K                                 # drop-free
    else:
        want = -(-int(n_local * K * capacity_factor) // m)
        slots = max(8, min(n_local * K, -(-want // 8) * 8))
    grp = shard.group(row_group)
    r = _rank(grp)
    lo, hi = r * n_local, min((r + 1) * n_local, B * T)
    x_loc = x.new_zeros((n_local, d))
    if hi > lo:
        x_loc[:hi - lo] = xf[lo:hi]
    # a shared expert split over "model" runs on the replicated input with
    # the tensor-parallel pattern after the gather; a whole one on the
    # local rows between the hops (1/n of the rows a rank)
    tp_shared = "shared" in params and shard.blocked("shared/w_gate")
    y_loc = _ragged_ep_shard(x_loc, params, cfg, slots=slots, m=m,
                             j=shard.j, group=shard.group("model"),
                             shared="shared" in params and not tp_shared)
    y = torch.empty((n_pad, d), dtype=y_loc.dtype, device=x.device)
    _all_gather(y, y_loc, grp)
    EP_CALLS["moe_ep_forward"] += 1
    y = y[:B * T].reshape(B, T, d)
    if tp_shared:
        y = y + apply_mlp(params["shared"], x, cfg.mlp_activation,
                          shard=shard.sub("shared"))
    return y


def ep_load_report(params: dict, cfg, tokens, ep_degree: int, *,
                   dtype_bytes: Optional[int] = None,
                   shard: Optional[Shard] = None) -> Optional[dict]:
    """Host-side expert-load skew probe for serving telemetry.

    Routes ``tokens`` through every MoE router via the embedding probe (the
    approximation of ``core/prefetch.router_probe``), folds the (E,)
    activation counts into per-rank loads, and reports the imbalance
    (max/mean over ranks) and the modeled per-rank all-to-all volume.
    None when there are no tokens or no MoE layers.  The math is numpy on
    explicit ``.cpu()`` copies of the embedding and router weights, so it
    launches nothing on the card, except the all-gather of a vocab-parallel
    embedding (``shard``'s placement, the model's) over ``"model"``."""
    toks = np.asarray(tokens).reshape(-1)
    if toks.size == 0 or not any(cfg.moe_pattern):
        return None
    table = params["embed"]["table"].detach()
    if shard is not None and shard.blocked("embed/table"):
        table = gather(table, 0, shard)       # a vocab block: every rank's
    table = table.float().cpu().numpy()
    x = table[toks.astype(np.int64)]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    counts = np.zeros((E,), np.float64)
    for l in range(cfg.num_layers):
        if not cfg.moe_pattern[l % cfg.period]:
            continue
        router = params["layers"][l]["ffn"]["router"].detach().float() \
            .cpu().numpy()
        logits = x @ router                                  # (n, E)
        # the K largest logits are the K activated experts (softmax is
        # monotone)
        topk = np.argpartition(-logits, K - 1, axis=-1)[..., :K]
        np.add.at(counts, topk.reshape(-1), 1.0)
    per_shard = counts.reshape(ep_degree, E // ep_degree).sum(-1)
    mean = float(per_shard.mean())
    if dtype_bytes is None:
        dtype_bytes = 4 if cfg.dtype == "float32" else 2
    return {
        "per_shard_load": per_shard.astype(int).tolist(),
        "imbalance": float(per_shard.max() / mean) if mean else 0.0,
        "a2a_bytes_per_device": ep_a2a_bytes(
            int(toks.size), K, cfg.d_model, ep_degree,
            dtype_bytes=dtype_bytes),
    }
