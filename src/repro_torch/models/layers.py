"""Core layers: norms, gated MLPs, embeddings, rotary embeddings.

Functional like the reference (``repro.models.layers``): ``init_*`` builds a
plain dict of tensors and ``apply_*`` maps tensors to tensors.  Initialisers
take an explicit ``torch.Generator`` and device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, *, generator: torch.Generator,
               device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init: a unit normal cut at +-3 std, then
    scaled (``trunc_normal_`` takes absolute bounds, so truncate first)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return w.mul_(std).to(dtype)


def embed_init(shape, dtype, *, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg, dtype, device) -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in params:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def act_fn(x: torch.Tensor, activation: str) -> torch.Tensor:
    """silu, or gelu with the tanh approximation (jax.nn.gelu's default)."""
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def init_mlp(d_model: int, d_ff: int, dtype, *, generator, device) -> dict:
    kw = dict(generator=generator, device=device)
    return {
        "w_gate": dense_init((d_model, d_ff), dtype, **kw),
        "w_up": dense_init((d_model, d_ff), dtype, **kw),
        "w_down": dense_init((d_ff, d_model), dtype, **kw),
    }


def apply_mlp(params: dict, x: torch.Tensor, activation: str = "silu", *,
              shard=None) -> torch.Tensor:
    """Gated MLP.  When ``shard`` (``distributed/collectives.Shard``, scoped
    to these params) places the leaves as this rank's ``"model"`` blocks
    (gate/up columns, down rows), Megatron's split: *f* at the input, *g*
    after down."""
    from repro_torch.distributed import collectives as col
    tp = shard is not None and shard.blocked("w_gate")
    if tp:
        x = col.copy_to(x, shard)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    y = (act_fn(gate, activation) * up) @ params["w_down"]
    return col.reduce_from(y, shard) if tp else y


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    ang = positions[..., None].float() * inv                 # (..., T, D/2)
    sin = torch.sin(ang)[..., None, :]                       # (..., T, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    ``positions``: (..., T, 3) (temporal, height, width) ids.  ``sections``:
    the rotary half-dims each component drives, in order; they sum to
    head_dim // 2.  With three equal ids it is 1-D RoPE exactly."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {d // 2}")
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    comp = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                      for i, s in enumerate(sections)])      # (D/2,)
    pos = positions.float()[..., comp]                       # (..., T, D/2)
    ang = pos * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal embedding (fp32) at arbitrary positions (..., T) →
    (..., T, d): [sin | cos] of pos / 10000^(2i/d)."""
    pos = positions.float()[..., None]
    i = torch.arange(d_model // 2, dtype=torch.float32,
                     device=positions.device)
    ang = pos / torch.pow(10_000.0, 2 * i / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(num_pos: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """The standard sinusoidal table (num_pos, d) (whisper's encoder)."""
    return sinusoidal_at(torch.arange(num_pos, device=device), d_model)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(vocab: int, d_model: int, dtype, *, generator, device) -> dict:
    return {"table": embed_init((vocab, d_model), dtype, generator=generator,
                                device=device)}


def embed(params: dict, tokens: torch.Tensor, scale: bool = False) -> torch.Tensor:
    x = params["table"][tokens]
    return scale_embedding(x) if scale else x


def scale_embedding(x: torch.Tensor) -> torch.Tensor:
    """Gemma-style sqrt(d) scaling of looked-up embeddings."""
    # a 0-dim CPU tensor rides along as a scalar, rounded to x's dtype
    # lint: allow[S403] a constant of the width, the same on every replay
    return x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype)


def unembed(params: dict, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = x @ params["table"].T
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x
