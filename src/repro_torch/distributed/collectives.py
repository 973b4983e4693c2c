"""Expert-parallel MoE dispatch over ``torch.distributed`` (the paper's
§3.4 deployment).

Port of ``repro.distributed.collectives``.  The one-hot dispatch runs every
token through every expert and the ``gmm`` dispatch needs every expert on
one device; this module shards the experts over the mesh's ``"model"`` axis
and moves the routed tokens to them through two all-to-all hops into the
ragged grouped matmul (kernels 1 and 2, ``kernels/gmm/ragged.py``):

  * expert weights: each rank holds ``E / m`` experts, the block of its
    ``"model"`` coordinate (``sharding.shard_params``; a whole leaf is
    sliced here);
  * token rows shard over EVERY rank of the mesh (each of the n ranks
    routes a disjoint slice, padded to an even split);
  * each rank ranks its (token, k) pairs per destination rank and sends
    the payloads with ``all_to_all_single`` over the ``"model"`` group:
    per-destination slot buffers, not dense (E, C) capacity bins;
  * the receiving rank sorts arrivals by LOCAL expert id and runs the
    ragged kernels with local group sizes; the slots nobody filled sort
    into a trailing group no expert owns, rows past ``sum(sizes)`` the
    kernels never touch and this module zeroes;
  * the shared expert runs on the local rows between the two hops;
  * the return all-to-all brings each pair's expert output home, where it
    is combined against the top-k weights in fp32, and an all-gather over
    the whole mesh hands every rank the replicated ``(B, T, d)`` output
    that the replicated layers downstream read (GSPMD inserts this gather
    implicitly in the reference).

Every shape comes from ``slots`` alone, and nothing reads the device from
the host, so an EP round is captured in the session's CUDA graphs like
any other (``core/graphs.py``).  ``EP_CALLS`` counts the calls that
really dispatched (a graph replay credits it, as it credits kernel
launches).  Per-layer collective cost: 2 x N·K·d / ep elements a rank,
``core/perf_model.ep_a2a_bytes``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.perf_model import ep_a2a_bytes
from repro_torch.distributed.constraints import resolve_mesh
from repro_torch.kernels.gmm import ragged
from repro_torch.launch.mesh import mesh_dims
from repro_torch.models.layers import act_fn

# expert-parallel forwards that went through the all-to-all dispatch
EP_CALLS = {"moe_ep_forward": 0}


def reset_ep_calls() -> None:
    EP_CALLS["moe_ep_forward"] = 0


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # all_gather_single is all_gather_into_tensor's newer name
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


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
                     m: int, j: int, group) -> torch.Tensor:
    """One rank's part (the reference's shard_map body): route the local
    rows ``x`` (N_loc, d), all-to-all the routed payloads to the ranks
    owning the chosen experts, run the local ragged FFN, all-to-all the
    results back and combine them against the top-k weights."""
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
    dist.all_to_all_single(recv, send[:m], group=group)
    dist.all_to_all_single(recv_eid, send_eid[:m], group=group)

    # 4. the shared expert on the local rows, between the hops
    shared_out = None
    if "shared" in params:
        s = params["shared"]
        shared_out = (act_fn(x @ s["w_gate"], cfg.mlp_activation)
                      * (x @ s["w_up"])) @ s["w_down"]

    # 5. local ragged FFN: arrivals sorted by local id (stable: source rank,
    #    then slot); group sizes by a scatter-add, which reads nothing back
    xs = recv.reshape(m * slots, d)
    eid = recv_eid.reshape(-1).to(torch.int64)
    order = torch.argsort(eid, stable=True)
    sizes = torch.zeros((e_local + 1,), dtype=torch.int32, device=dev)
    sizes.scatter_add_(0, eid, torch.ones_like(eid, dtype=torch.int32))
    sizes = sizes[:e_local]
    ys = ragged.ragged_moe_ffn(xs[order].contiguous(), w_gate.contiguous(),
                               w_up.contiguous(), w_down.contiguous(), sizes,
                               activation=cfg.mlp_activation)
    real = torch.arange(m * slots, device=dev) < sizes.sum()
    ys = torch.where(real[:, None], ys, torch.zeros_like(ys)).to(x.dtype)
    back = torch.empty_like(ys).index_copy_(0, order, ys).view(m, slots, d)

    # 6. return hop, then the top-k combine in fp32, each token's K rows in
    #    (token, k) order summed by one reduction (the same bits eager and
    #    replayed; the reference scatter-adds them)
    ret = torch.empty_like(back)
    dist.all_to_all_single(ret, back, group=group)
    gathered = ret[torch.where(kept, dest, torch.zeros_like(dest)), slot]
    wk = weights.reshape(-1) * kept
    out = (gathered.float() * wk[:, None]).view(N, K, d).sum(1).to(x.dtype)
    if shared_out is not None:
        out = out + shared_out
    return out


def moe_ep_forward(params: dict, cfg, x: torch.Tensor, *, mesh=None,
                   layout: Optional[str] = None,
                   capacity_factor: Optional[float] = None) -> torch.Tensor:
    """(B, T, d) -> (B, T, d) expert-parallel MoE FFN on every rank of
    ``mesh`` (module docstring).  ``capacity_factor=None`` sizes each
    destination's slot buffer to the drop-free worst case N_loc·K, so the
    output equals the single-device ``gmm`` dispatch's; a finite factor
    trades all-to-all volume for drops under skew, pair for pair as the
    reference drops them.  With no mesh, or ``E`` not divisible over
    ``"model"``, this is the one-hot dispatch, as in the reference."""
    from repro_torch.models import moe as moe_mod

    mesh, layout = resolve_mesh(mesh, layout)
    dims = None if mesh is None else mesh_dims(mesh)
    if dims is None or "model" not in dims \
            or cfg.num_experts % dims["model"] != 0:
        return moe_mod.moe_forward(params, cfg, x, dispatch="onehot")[0]
    B, T, d = x.shape
    m = dims["model"]
    n_shards = math.prod(dims.values())
    K = cfg.num_experts_per_tok
    # row-shard tokens over the whole mesh, padded to an even split with
    # zero rows (routed, computed, sliced off)
    xf = x.reshape(B * T, d)
    n_pad = -(-(B * T) // n_shards) * n_shards
    n_local = n_pad // n_shards
    if capacity_factor is None:
        slots = n_local * K                                 # drop-free
    else:
        want = -(-int(n_local * K * capacity_factor) // m)
        slots = max(8, min(n_local * K, -(-want // 8) * 8))
    r = dist.get_rank()                         # the mesh is the world
    lo, hi = r * n_local, min((r + 1) * n_local, B * T)
    x_loc = x.new_zeros((n_local, d))
    if hi > lo:
        x_loc[:hi - lo] = xf[lo:hi]
    y_loc = _ragged_ep_shard(x_loc, params, cfg, slots=slots, m=m,
                             j=mesh.get_local_rank("model"),
                             group=mesh.get_group("model"))
    y = torch.empty((n_pad, d), dtype=y_loc.dtype, device=x.device)
    _all_gather(y, y_loc, None)
    EP_CALLS["moe_ep_forward"] += 1
    return y[:B * T].reshape(B, T, d)


def ep_load_report(params: dict, cfg, tokens, ep_degree: int, *,
                   dtype_bytes: Optional[int] = None) -> Optional[dict]:
    """Host-side expert-load skew probe for serving telemetry.

    Routes ``tokens`` through every MoE router via the embedding probe (the
    approximation of ``core/prefetch.router_probe``), folds the (E,)
    activation counts into per-rank loads, and reports the imbalance
    (max/mean over ranks) and the modeled per-rank all-to-all volume.
    None when there are no tokens or no MoE layers.  The math is numpy on
    explicit ``.cpu()`` copies of the embedding and router weights, so it
    launches nothing on the card."""
    toks = np.asarray(tokens).reshape(-1)
    if toks.size == 0 or not any(cfg.moe_pattern):
        return None
    table = params["embed"]["table"].detach().float().cpu().numpy()
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
