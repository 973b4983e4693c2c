"""Plain float32 forward of the benchmark's models, computed layer by layer.

What the served tokens are judged against.  It follows the published
decoders of the configurations under ``perfbench/configs`` and reads the
parameter tree the benchmark made (``perfbench/harness/weights.py``), nothing
of the program: no kernel, cache, batching or helper of it.

A ``spec`` is a dict of sizes:

    d, layers, heads, kv_heads, head_dim, vocab, eps, theta, qkv_bias,
    tie, ff (dense FFN width, 0 for an MoE layer), experts, top_k,
    expert_ff, shared_ff (0: none)

The decoder: pre-RMSNorm blocks (scale on the normalised row), GQA
attention with rotary positions (the halves of each head rotated, base
``theta``) and q/k/v biases where ``qkv_bias``, a SwiGLU FFN; an MoE layer
routes each token by a float32 softmax over its router's logits to its
``top_k`` experts, weights them by their probabilities renormalised to sum
to one, and adds an always-on shared SwiGLU expert of width ``shared_ff``.
A final RMSNorm and the head (the embedding table where ``tie``) give the
logits.

Departures from the published descriptions, all as the system under test
computes them:

* Qwen2-57B-A14B publishes ``norm_topk_prob: false`` and a sigmoid gate on
  its shared expert; here the top-k weights are renormalised and the shared
  expert is added ungated.
* An EAGLE head (``eagle_rounds``) attends over its own keys only;
  positions it never processed hold zero keys and values (the head's cache
  is filled only by its own steps), and the steps a round kept carry the
  features the head predicted, not the target's.

``precision="fp8"`` is the control: every weight matrix rounded to
float8 e4m3 with a scale per output column, every activation entering a
weight product rounded to e4m3 with a scale per row; attention's own
products and the norms stay in float32.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp32_matmul_exact():
    """Turn TF32 off for float32 products (a float32 reference on an
    Ampere-or-later card would otherwise multiply in TF32).  Returns the
    previous settings for :func:`restore_matmul`."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def restore_matmul(prev) -> None:
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def _e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's absolute maximum maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear:
    """Weight products in float32, or in e4m3 (the control)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _e4m3(w, dim=-2) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x`` (..., K) @ ``w`` (K, N), ``w`` already through ``weight``."""
        if self.fp8:
            x = _e4m3(x, dim=-1)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x (T, H, D) at ``positions`` (T,): the first and second halves of
    each head rotated by angle position / theta^(2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = positions.float()[:, None] * inv                  # (T, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, q_pos, k_pos, block: int = 1024) -> torch.Tensor:
    """Causal GQA: q (T, H, D), k/v (S, Hkv, D); query t sees keys whose
    position is <= its own.  Computed in blocks of ``block`` queries."""
    T, H, D = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)       # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        qb = q[lo:hi].transpose(0, 1)                        # (H, t, D)
        s = (qb @ k.transpose(1, 2)) / math.sqrt(D)          # (H, t, S)
        s = s.masked_fill(k_pos[None, None, :] > q_pos[lo:hi][None, :, None],
                          float("-inf"))
        out[lo:hi] = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)
    return out


def swiglu(x, w_gate, w_up, w_down, lin: Linear) -> torch.Tensor:
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def _layer_weights(layer: dict, lin: Linear) -> dict:
    """One block's leaves in float32 (through ``lin.weight`` for the
    matrices); expert stacks stay as they are and are converted an expert
    at a time (``moe``), so that no layer is ever held whole at float32."""
    def conv(path: str, t):
        if isinstance(t, dict):
            return {k: conv(k, v) for k, v in t.items()}
        if t.dim() >= 3:
            return t
        if t.dim() == 2 and path != "router":
            return lin.weight(t)
        return t.float()
    return conv("", layer)


def attention_block(h, w, spec, positions, lin: Linear, k_cache=None,
                    k_pos=None):
    """The attention sublayer on one sequence's normalised rows h (T, d).
    ``k_cache`` ((k, v) of earlier positions, with ``k_pos``) is prepended;
    returns (output (T, d), (k, v) of these rows)."""
    T = h.shape[0]
    H, Hkv, D = spec["heads"], spec["kv_heads"], spec["head_dim"]
    q, k, v = lin(h, w["wq"]), lin(h, w["wk"]), lin(h, w["wv"])
    if spec["qkv_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rotary(q.view(T, H, D), positions, spec["theta"])
    k = rotary(k.view(T, Hkv, D), positions, spec["theta"])
    v = v.view(T, Hkv, D)
    kk, vv, kp = k, v, positions
    if k_cache is not None:
        kk = torch.cat([k_cache[0], k], 0)
        vv = torch.cat([k_cache[1], v], 0)
        kp = torch.cat([k_pos, positions], 0)
    o = attention(q, kk, vv, positions, kp)
    return lin(o.reshape(T, H * D), w["wo"]), (k, v)


def moe(x, w, spec, lin: Linear, routes: Optional[list] = None
        ) -> torch.Tensor:
    """Routed experts plus the shared expert on rows x (N, d); ``routes``
    receives each row's chosen experts (N, top_k)."""
    probs = torch.softmax(x @ w["router"].float(), dim=-1)
    top_w, top_i = torch.topk(probs, spec["top_k"], dim=-1)
    if routes is not None:
        routes.append(top_i.to(torch.int16).cpu())
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(spec["experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], lin.weight(w["w_gate"][e]),
                   lin.weight(w["w_up"][e]), lin.weight(w["w_down"][e]), lin)
        out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    if spec["shared_ff"]:
        s = w["shared"]
        out = out + swiglu(x, s["w_gate"], s["w_up"], s["w_down"], lin)
    return out


def ffn(x, w, spec, lin: Linear, routes: Optional[list] = None
        ) -> torch.Tensor:
    if spec["experts"]:
        return moe(x, w, spec, lin, routes)
    return swiglu(x, w["w_gate"], w["w_up"], w["w_down"], lin)


def decoder_hidden(spec: dict, params: dict, seqs: Sequence[torch.Tensor],
                   lin: Optional[Linear] = None,
                   routes: Optional[list] = None) -> List[torch.Tensor]:
    """Final hidden rows (before the final norm) of every sequence in
    ``seqs`` (token ids (L,)), positions 0..L-1, layer by layer: each
    layer's weights are made float32 once and applied to every sequence.
    ``routes`` receives, for each MoE layer, every sequence's chosen
    experts (L, top_k)."""
    lin = lin or Linear()
    table = params["embed"]["table"]
    hs = [table[s.to(table.device)].float() for s in seqs]
    pos = [torch.arange(s.numel(), device=table.device) for s in seqs]
    for layer in params["layers"]:
        w = _layer_weights(layer, lin)
        for i, x in enumerate(hs):
            a, _ = attention_block(rms_norm(x, w["norm1"]["scale"],
                                            spec["eps"]),
                                   w["mixer"], spec, pos[i], lin)
            hs[i] = x + a
        # the FFN is position-wise: every sequence's rows at once
        x = torch.cat(hs, 0)
        chosen = [] if routes is not None else None
        x = x + ffn(rms_norm(x, w["norm2"]["scale"], spec["eps"]),
                    w["ffn"], spec, lin, chosen)
        if chosen:
            routes.append(list(torch.split(chosen[0],
                                           [h.shape[0] for h in hs])))
        hs = list(torch.split(x, [h.shape[0] for h in hs]))
        del w, x
    return hs


def head_logits(spec: dict, params: dict, h: torch.Tensor,
                lin: Optional[Linear] = None, block: int = 16384
                ) -> torch.Tensor:
    """Logits (T, V) of final hidden rows h (T, d), ``block`` rows of the
    vocabulary at a time."""
    lin = lin or Linear()
    x = rms_norm(h, params["final_norm"]["scale"], spec["eps"])
    table = params["embed" if spec["tie"] else "head"]["table"]
    out = torch.empty((x.shape[0], table.shape[0]), device=x.device)
    for lo in range(0, table.shape[0], block):
        hi = min(lo + block, table.shape[0])
        out[:, lo:hi] = lin(x, lin.weight(table[lo:hi].t()))
    return out


def logits_at(spec: dict, params: dict, seqs: Sequence[torch.Tensor],
              starts: Sequence[int], precision: str = "fp32"
              ) -> List[torch.Tensor]:
    """For each sequence, the logits (L - start, V) predicting its tokens
    ``start..L-1``: the rows at positions ``start-1..L-2``."""
    lin = Linear(precision)
    hs = decoder_hidden(spec, params, seqs, lin)
    return [head_logits(spec, params, h[s - 1: h.shape[0] - 1], lin)
            for h, s in zip(hs, starts)]


def eagle_rounds(spec: dict, head_spec: dict, params_t: dict,
                 params_h: dict, seq: torch.Tensor, feats: torch.Tensor,
                 prompt_len: int, rounds: Sequence[tuple],
                 lin: Optional[Linear] = None) -> torch.Tensor:
    """An EAGLE head (arXiv:2401.15077) drafting one request round by round.

    ``seq`` holds the prompt and the served tokens, ``feats`` (L, d) the
    target's final hidden rows over it, and ``rounds`` each round's
    (c, drafts (g,)): c served tokens came before it.  A round starts at
    position p = ``prompt_len`` + c - 1 from the served token there and the
    target's feature at p - 1; each later step fuses the embedding of the
    draft before it with the feature the head itself predicted.  Every
    step writes its keys and values at its position and attends over
    positions up to it, so a round's steps that the next round does not
    overwrite are the ones it kept; positions the head never processed (the
    prompt) hold zero keys and values.  Returns the logits (the target's
    head on the predicted features) predicting every draft, round after
    round.  The head's block uses the target's rotary base and norm
    epsilon; ``head_spec`` gives its heads, head size and FFN width."""
    lin = lin or Linear()
    hspec = dict(spec, **head_spec)
    w = _layer_weights(params_h["layers"][0], lin)
    fuse = lin.weight(params_h["fuse"])
    table = params_t["embed"]["table"]
    dev = feats.device
    width = max((len(d) for _, d in rounds), default=0)
    size = seq.shape[0] + width + 1
    K = torch.zeros((size, hspec["kv_heads"], hspec["head_dim"]), device=dev)
    V = torch.zeros_like(K)
    seq = seq.to(dev)
    out = []
    for c, drafts in rounds:
        p = prompt_len + int(c) - 1
        token, feat = seq[p], feats[p - 1]
        for j in range(len(drafts)):
            x = lin(torch.cat([table[token].float(), feat.float()])[None],
                    fuse)
            pos = torch.tensor([p], device=dev)
            a, (k, v) = attention_block(
                rms_norm(x, w["norm1"]["scale"], hspec["eps"]), w["mixer"],
                hspec, pos, lin, k_cache=(K[:p], V[:p]),
                k_pos=torch.arange(p, device=dev))
            K[p], V[p] = k[0], v[0]
            x = x + a
            x = x + swiglu(rms_norm(x, w["norm2"]["scale"], hspec["eps"]),
                           w["ffn"]["w_gate"], w["ffn"]["w_up"],
                           w["ffn"]["w_down"], lin)
            out.append(x)
            feat, token, p = x[0], int(drafts[j]), p + 1
    if not out:
        return torch.empty((0, spec["vocab"]), device=dev)
    return head_logits(spec, params_t, torch.cat(out), lin)
