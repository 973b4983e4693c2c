"""Recurrent blocks: Mamba selective SSM (Jamba) and xLSTM (mLSTM / sLSTM).

Port of ``repro.models.ssm``.  Every block has the interface

    forward(params, cfg, x, state, collect_states=False)
        -> (y, final_state) or (y, stacked_states)

where ``x`` (B, T, d) is consumed step by step from ``state``.  With
``collect_states=True`` every per-step state comes back with a leading time
axis (T, B, ...): the speculative-decoding engine gathers the state at the
last accepted position (``Model.commit``) instead of rolling one back.
``state`` is only read; the caller writes what it keeps.

Recurrent states:
  mamba  {"conv": (B, c-1, d_in), "ssm": (B, d_in, n_state)}
  mlstm  {"conv": (B, c-1, d_in), "C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}
  slstm  {"c": (B, d), "n": (B, d), "m": (B, d), "h": (B, d)}

The reference scans time with ``lax.scan``; the forward here is the same
recurrence as a per-step loop of torch ops, with the reference's casts:
Mamba rounds ``dt``, ``B`` and ``C`` to the model dtype and steps in fp32,
mLSTM scales k after its fp32 cast, sLSTM runs its gates and recurrent
products in fp32.  Under autograd a loop of T > SCAN_CHUNK steps, T a
multiple of it and nothing collected, runs as T / SCAN_CHUNK checkpointed
slices (``_scan_time``), as the reference rematerialises its scan.  On the
meta device, where the dry-run only counts a step (``launch/dryrun.py``),
the loop runs one step counted T times (``_scan_counted``).  The
reference has no Pallas kernel here, so neither is there a CUDA one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import costs
from repro_torch.models.layers import dense_init

CONV_K = 4  # causal conv kernel size (mamba / mlstm)

# Backward through a T-step loop keeps every step's state.  Checkpointing
# each SCAN_CHUNK-step slice keeps only the carries between slices and
# recomputes inside a slice (the reference's chunked remat).
SCAN_CHUNK = 256


def _scan_time(run, carry: tuple, xs: tuple, collect: bool,
               consts: tuple = ()):
    """``run(carry, xs, consts) -> (carry, ys)`` over the time axis (dim 1)
    of every tensor of ``xs``; ``ys`` (B, T, ...); ``consts``, the tensors
    from outside the loop that every step reads (a gradient flows to them
    through ``run``'s argument, never through what it closes over).  Under
    autograd (grad on and an input requiring grad), T > SCAN_CHUNK, T a
    multiple of it and nothing collected, each slice runs under a
    non-reentrant checkpoint; otherwise (serving, CUDA graphs) ``run`` runs
    once over all of T."""
    if xs[0].device.type == "meta" and not collect and xs[0].shape[1] > 1:
        return _scan_counted(run, carry, xs, consts)
    return _scan_loop(run, carry, xs, collect, consts)


def _scan_loop(run, carry: tuple, xs: tuple, collect: bool, consts: tuple):
    """``_scan_time`` step by step, on any device."""
    T = xs[0].shape[1]
    training = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*carry, *xs, *consts))
    if collect or not training or T <= SCAN_CHUNK or T % SCAN_CHUNK:
        return run(carry, xs, consts)
    ys = []
    for t0 in range(0, T, SCAN_CHUNK):
        carry, y = checkpoint(run, carry,
                              tuple(x[:, t0:t0 + SCAN_CHUNK] for x in xs),
                              consts, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


def _all_steps(y: torch.Tensor, T: int) -> torch.Tensor:
    """A fresh (B, T, ...) tensor standing for one step's (B, 1, ...)
    output at every step."""
    return y.new_empty((y.shape[0], T) + tuple(y.shape[2:]))


class _CountedStep(torch.autograd.Function):
    """One step standing for ``n`` under autograd: counted ``n`` times
    forward, and ``n`` times recomputed and differentiated backward (a
    middle step's: its carry's gradient comes from the next step), as the
    checkpointed slices of ``_scan_loop`` are.  Their FLOPs agree within a
    few per cent; their bytes do not: the loop's backward of each step's
    slice ``x[:, t]`` writes a gradient buffer of the whole slice, which
    one step of length 1 does not (reduced jamba and xlstm at T 512: the
    loop moves about twice the bytes)."""

    @staticmethod
    def forward(ctx, n, run, n_carry, n_xs, *ts):
        ctx.n, ctx.run, ctx.split = n, run, (n_carry, n_carry + n_xs)
        ctx.save_for_backward(*ts)
        with costs.repeat(n):
            carry, y = run(*_split(ts, ctx.split))
        return (*carry, _all_steps(y, n))

    @staticmethod
    def backward(ctx, *grads):
        ts = tuple(t.detach().requires_grad_(t.requires_grad)
                   for t in ctx.saved_tensors)
        with torch.enable_grad(), costs.repeat(ctx.n):
            carry, y = ctx.run(*_split(ts, ctx.split))
            # the carry's gradient stands in for the next step's (allocated,
            # not counted as moved bytes)
            outs = [(o, torch.empty_like(o)) for o in carry]
            if grads[-1] is not None:
                outs.append((y, grads[-1][:, :1]))
            outs = [(o, g) for o, g in outs if o.requires_grad]
            need = [t for t in ts if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in outs], need, [g for _, g in outs],
                allow_unused=True) if outs and need else ())
        return (None, None, None, None) + tuple(
            next(got) if t.requires_grad else None for t in ts)


def _split(ts: tuple, at: tuple):
    return ts[:at[0]], ts[at[0]:at[1]], ts[at[1]:]


def _scan_counted(run, carry: tuple, xs: tuple, consts: tuple):
    """The loop on the meta device, for the dry-run's counts: its T steps
    cost the same, so one step runs, counted T times
    (``launch/costs.repeat``), and its output stands for every step's
    (``_all_steps``).  Under autograd the step is recomputed and
    differentiated T times in the backward, as the checkpointed slices
    are."""
    T = xs[0].shape[1]
    xs1 = tuple(x[:, :1] for x in xs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*carry, *xs1, *consts)):
        out = _CountedStep.apply(T, run, len(carry), len(xs1), *carry, *xs1,
                                 *consts)
        return tuple(out[:-1]), out[-1]
    with costs.repeat(T):
        carry, y = run(carry, xs1, consts)
    return carry, _all_steps(y, T)


def _causal_conv(params, xb, conv_state):
    """Depthwise causal conv of width CONV_K over ``xb`` (B, T, d_in) after
    the carried inputs ``conv_state`` (B, K-1, d_in): returns the conv's
    output (B, T, d_in) and its whole input (B, T+K-1, d_in)."""
    conv_in = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
    windows = conv_in.unfold(1, CONV_K, 1)                  # (B, T, d_in, K)
    xc = torch.einsum("btdk,kd->btd", windows, params["conv_w"]) \
        + params["conv_b"]
    return xc, conv_in


def _conv_history(conv_in, T: int):
    """(T, B, K-1, d_in): the conv state after each of the T inputs."""
    return torch.stack([conv_in[:, t + 1:t + CONV_K] for t in range(T)])


# ---------------------------------------------------------------------------
# Mamba (selective SSM, arXiv:2312.00752 as used by Jamba arXiv:2403.19887)
# ---------------------------------------------------------------------------

def _dt_rank(cfg) -> int:
    return cfg.ssm_dt_rank or -(-cfg.d_model // 16)


def init_mamba(cfg, dtype, *, generator, device) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    r = _dt_rank(cfg)
    kw = dict(generator=generator, device=device)
    A = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device).expand(d_in, n)
    return {
        "w_in": dense_init((d, 2 * d_in), dtype, **kw),
        "conv_w": dense_init((CONV_K, d_in), dtype, scale=1.0, **kw),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "w_xdbc": dense_init((d_in, r + 2 * n), dtype, **kw),
        "w_dt": dense_init((r, d_in), dtype, **kw),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32,
                              device=device),      # softplus^-1(0.01)
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "w_out": dense_init((d_in, d), dtype, **kw),
    }


def make_mamba_state(cfg, batch: int, dtype, device) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, CONV_K - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_forward(params, cfg, x, state, collect_states: bool = False):
    B, T, d = x.shape
    n = cfg.ssm_state_dim
    r = _dt_rank(cfg)

    xb, z = (x @ params["w_in"]).chunk(2, dim=-1)            # (B,T,d_in) each
    xc, conv_in = _causal_conv(params, xb, state["conv"])
    xc = F.silu(xc)

    dbc = xc @ params["w_xdbc"]
    dt = F.softplus(dbc[..., :r] @ params["w_dt"] + params["dt_bias"])
    A = -torch.exp(params["A_log"])                          # (d_in, n)
    md = x.dtype
    # the step inputs in the model dtype, each step in fp32 (reference)
    dt_s = dt.to(md).float()
    B_s = dbc[..., r:r + n].float().to(md).float()
    C_s = dbc[..., r + n:].float().to(md).float()
    x_s = xc.float()

    hs = (torch.empty((T,) + tuple(state["ssm"].shape), dtype=torch.float32,
                      device=x.device) if collect_states else None)

    def run(carry, xs, consts):
        (h,), (dt_c, B_c, C_c, x_c), (A,) = carry, xs, consts
        ys = []
        for t in range(dt_c.shape[1]):
            dt_t = dt_c[:, t]
            dec = torch.exp(dt_t[..., None] * A)             # (B, d_in, n)
            drv = (dt_t * x_c[:, t])[..., None] * B_c[:, t][:, None, :]
            h = dec * h + drv
            if hs is not None:
                hs[t] = h
            ys.append(torch.einsum("bdn,bn->bd", h, C_c[:, t]))
        return (h,), torch.stack(ys, dim=1)

    (h,), y = _scan_time(run, (state["ssm"],), (dt_s, B_s, C_s, x_s),
                         collect_states, (A,))               # (B, T, d_in)
    y = y + params["D"] * xc.float()
    y = y.to(md) * F.silu(z)
    out = y @ params["w_out"]
    if collect_states:
        return out, {"conv": _conv_history(conv_in, T), "ssm": hs}
    return out, {"conv": conv_in[:, T:].to(state["conv"].dtype), "ssm": h}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory, arXiv:2405.04517)
# ---------------------------------------------------------------------------

def init_mlstm(cfg, dtype, *, generator, device) -> dict:
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.num_heads
    kw = dict(generator=generator, device=device)
    return {
        "w_up": dense_init((d, 2 * d_in), dtype, **kw),
        "conv_w": dense_init((CONV_K, d_in), dtype, **kw),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "wq": dense_init((d_in, d_in), dtype, **kw),
        "wk": dense_init((d_in, d_in), dtype, **kw),
        "wv": dense_init((d_in, d_in), dtype, **kw),
        "w_i": dense_init((d_in, H), torch.float32, **kw),
        "w_f": dense_init((d_in, H), torch.float32, **kw),
        "f_bias": torch.full((H,), 3.0, dtype=torch.float32,
                             device=device),       # forget ~1 at init
        "i_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "w_down": dense_init((d_in, d), dtype, **kw),
    }


def make_mlstm_state(cfg, batch: int, dtype, device) -> dict:
    d_in = 2 * cfg.d_model
    H = cfg.num_heads
    hd = d_in // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, d_in), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, H, hd, hd), **f32),
        "n": torch.zeros((batch, H, hd), **f32),
        "m": torch.zeros((batch, H), **f32),
    }


def mlstm_forward(params, cfg, x, state, collect_states: bool = False):
    B, T, d = x.shape
    d_in = 2 * d
    H = cfg.num_heads
    hd = d_in // H

    xb, z = (x @ params["w_up"]).chunk(2, dim=-1)
    xc, conv_in = _causal_conv(params, xb, state["conv"])
    xc = F.silu(xc)

    q = (xc @ params["wq"]).reshape(B, T, H, hd).float()
    k = (xc @ params["wk"]).reshape(B, T, H, hd).float() / math.sqrt(hd)
    v = (xc @ params["wv"]).reshape(B, T, H, hd).float()
    xf = xc.float()
    i_raw = xf @ params["w_i"] + params["i_bias"]             # (B, T, H)
    f_log = F.logsigmoid(xf @ params["w_f"] + params["f_bias"])

    if collect_states:
        Cs, ns, ms = (torch.empty((T,) + tuple(state[k].shape),
                                  dtype=torch.float32, device=x.device)
                      for k in ("C", "n", "m"))

    def run(carry, xs, consts):
        (C, n_s, m), (q_c, k_c, v_c, i_c, f_c) = carry, xs
        hs = []
        for t in range(q_c.shape[1]):
            q_t, k_t, v_t = q_c[:, t], k_c[:, t], v_c[:, t]  # (B, H, hd)
            i_t, f_t = i_c[:, t], f_c[:, t]                   # (B, H)
            m_new = torch.maximum(f_t + m, i_t)
            i_p = torch.exp(i_t - m_new)[..., None]           # (B, H, 1)
            f_p = torch.exp(f_t + m - m_new)[..., None]
            # C' = f C + (i v) k^T: two passes over C, the outer product
            # accumulated by one batched rank-1 product; written straight
            # into the step's collect slot when collecting (the (T, B, H,
            # hd, hd) stack is the round's largest buffer at xlstm width).
            # Autograd takes only the form without out=.
            C_new = Cs[t] if collect_states else None
            C_new = torch.mul(f_p[..., None], C, out=C_new)
            C_new.view(B * H, hd, hd).baddbmm_(
                (i_p * v_t).reshape(B * H, hd, 1), k_t.reshape(B * H, 1, hd))
            C = C_new
            n_s = f_p * n_s + i_p * k_t
            m = m_new
            if collect_states:
                ns[t] = n_s
                ms[t] = m
            h_num = torch.einsum("bhij,bhj->bhi", C, q_t)
            h_den = torch.clamp(torch.einsum("bhd,bhd->bh", n_s, q_t).abs(),
                                min=1.0)
            hs.append(h_num / h_den[..., None])
        return (C, n_s, m), torch.stack(hs, dim=1)

    (C, n_s, m), h = _scan_time(run, (state["C"], state["n"], state["m"]),
                                (q, k, v, i_raw, f_log), collect_states)
    h = h.reshape(B, T, d_in).to(x.dtype)
    out = (h * F.silu(z)) @ params["w_down"]
    if collect_states:
        return out, {"conv": _conv_history(conv_in, T), "C": Cs, "n": ns,
                     "m": ms}
    return out, {"conv": conv_in[:, T:].to(state["conv"].dtype),
                 "C": C, "n": n_s, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory with exponential gating)
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def init_slstm(cfg, dtype, *, generator, device) -> dict:
    d = cfg.d_model
    f = (4 * d) // 3
    kw = dict(generator=generator, device=device)
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = dense_init((d, d), dtype, **kw)
        p[f"r_{g}"] = dense_init((d, d), dtype, **kw)
        p[f"b_{g}"] = torch.full((d,), 3.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=device)
    p["w_ffn_up"] = dense_init((d, f), dtype, **kw)
    p["w_ffn_down"] = dense_init((f, d), dtype, **kw)
    return p


def make_slstm_state(cfg, batch: int, dtype, device) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}


def slstm_forward(params, cfg, x, state, collect_states: bool = False):
    B, T, d = x.shape
    x32 = x.float()
    pre = {g: x32 @ params[f"w_{g}"].float() for g in _GATES}
    # the recurrent weights in fp32 and the biases, read by every step
    consts = (tuple(params[f"r_{g}"].float() for g in _GATES)
              + tuple(params[f"b_{g}"] for g in _GATES))
    steps = [] if collect_states else None

    def run(carry, xs, consts):
        (c, n, m, h), (pz, pi, pf, po) = carry, xs
        r_z, r_i, r_f, r_o, b_z, b_i, b_f, b_o = consts
        hs = []
        for t in range(pz.shape[1]):
            z_t = torch.tanh(pz[:, t] + h @ r_z + b_z)
            i_t = pi[:, t] + h @ r_i + b_i
            f_t = F.logsigmoid(pf[:, t] + h @ r_f + b_f)
            o_t = torch.sigmoid(po[:, t] + h @ r_o + b_o)
            m_new = torch.maximum(f_t + m, i_t)
            i_p = torch.exp(i_t - m_new)
            f_p = torch.exp(f_t + m - m_new)
            c = f_p * c + i_p * z_t
            n = f_p * n + i_p
            h = o_t * c / torch.clamp(n, min=1e-6)
            m = m_new
            if steps is not None:
                steps.append((c, n, m, h))
            hs.append(h)
        return (c, n, m, h), torch.stack(hs, dim=1)

    (c, n, m, h), hs = _scan_time(
        run, tuple(state[k] for k in ("c", "n", "m", "h")),
        tuple(pre[g] for g in _GATES), collect_states, consts)
    out = F.gelu(hs.to(x.dtype) @ params["w_ffn_up"], approximate="tanh") \
        @ params["w_ffn_down"]
    if collect_states:
        return out, {k: torch.stack([s[i] for s in steps])
                     for i, k in enumerate(("c", "n", "m", "h"))}
    return out, {"c": c, "n": n, "m": m, "h": h}


FORWARD = {"mamba": mamba_forward, "mlstm": mlstm_forward,
           "slstm": slstm_forward}
INIT = {"mamba": init_mamba, "mlstm": init_mlstm, "slstm": init_slstm}
MAKE_STATE = {"mamba": make_mamba_state, "mlstm": make_mlstm_state,
              "slstm": make_slstm_state}
