"""Batched rejection sampling for speculative decoding (Leviathan et al.).

Port of ``repro.core.rejection``.  Losslessness: for every sequence the
emitted tokens are distributed exactly as samples from the target model.
Accept draft token d_i with probability min(1, p_i(d_i)/q_i(d_i)); on the
first rejection sample from the residual norm(max(p_i − q_i, 0)); if all
gamma drafts are accepted, emit a bonus token from p_gamma.  Greedy decoding
is the temperature→0 limit: acceptance degenerates to argmax equality and SD
output is token-for-token identical to greedy AR decoding.

Randomness comes from an explicit ``torch.Generator`` in place of a JAX key;
the two give different streams, so sampled outputs match the reference in
distribution, not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def probs_from_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Softmax with temperature; temperature <= 0 → one-hot argmax (greedy)."""
    if temperature <= 0.0:
        # scatter, not F.one_hot: one_hot validates its indices on the host
        return torch.zeros(logits.shape, dtype=torch.float32,
                           device=logits.device).scatter_(
            -1, logits.argmax(-1, keepdim=True), 1.0)
    return torch.softmax(logits.float() / temperature, dim=-1)


def sample_from(probs: torch.Tensor, generator: Optional[torch.Generator],
                temperature: float) -> torch.Tensor:
    """Greedy argmax, or a categorical sample by the Gumbel-max trick
    (what ``jax.random.categorical`` does; no host sync)."""
    if temperature <= 0.0:
        return probs.argmax(-1).to(torch.int32)
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (torch.log(probs.clamp(min=1e-30)) + gumbel).argmax(-1).to(torch.int32)


def rejection_sample(
    p: torch.Tensor,            # (B, gamma+1, V) target distributions
    q: torch.Tensor,            # (B, gamma,   V) draft distributions
    drafts: torch.Tensor,       # (B, gamma)      proposed tokens
    generator: Optional[torch.Generator],
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (n_accept (B,), next_token (B,), accept_mask (B, gamma)).

    Committed tokens per sequence = drafts[:n_accept] + [next_token], i.e.
    n_accept + 1 new tokens."""
    B, gamma = drafts.shape
    d = drafts.to(torch.int64)[..., None]
    p_d = torch.gather(p[:, :gamma], 2, d)[..., 0]
    q_d = torch.gather(q, 2, d)[..., 0]
    ratio = p_d / q_d.clamp(min=1e-30)
    if temperature <= 0.0:
        accept = p_d > 0.5                              # one-hot match
    else:
        u = torch.rand((B, gamma), generator=generator, device=p.device)
        accept = u < ratio
    # n_accept = number of leading accepts
    n_accept = torch.cumprod(accept.to(torch.int32), dim=-1).sum(-1)   # (B,)

    # distribution for the extra token: residual at the rejection position,
    # or the bonus distribution p_gamma when everything was accepted
    V = p.shape[-1]
    at = n_accept.to(torch.int64)[:, None, None].expand(B, 1, V)
    p_at = torch.gather(p, 1, at)[:, 0]                                # (B,V)
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    q_at = torch.gather(q_pad, 1, at)[:, 0]
    rejected_somewhere = n_accept < gamma
    residual = (p_at - q_at).clamp(min=0.0)
    residual_sum = residual.sum(-1, keepdim=True)
    # fall back to p when the residual vanishes (q == p pointwise)
    residual = torch.where(residual_sum > 1e-12,
                           residual / residual_sum.clamp(min=1e-30), p_at)
    extra_dist = torch.where(rejected_somewhere[:, None], residual, p_at)
    next_token = sample_from(extra_dist, generator, temperature)
    return n_accept.to(torch.int32), next_token, accept
