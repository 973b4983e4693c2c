"""Whether the window served the right tokens, and drafted with the right
drafter.

``SAMPLE`` of the requests the window finished, drawn from the seed with
the longest among them, are run through the plain float32 reference
(``perfbench/reference``) over each prompt with its served tokens.  Each
served token's gap is how far its logit lies below the reference's best at
its position: greedy decoding serves the target's argmax, so a sound run
reads only what rounding in the program's bf16 flips between near ties.
The number compared is the 90th percentile of the gaps over every sampled
token (``gap_p90``).  The widest gap is printed too, and not compared: with
random weights the bf16 program flips expert routing and the argmax
between near ties on some tokens of every run, and the widest gap is set
by the rarest such flip, as wide as the float8 control's.

Greedy speculative decoding serves the target's tokens whatever the
drafter proposes, so where the cell drafts, the drafts the timed path
proposed for the same requests (``drafts.Recorder``) are judged the same
way against the reference's drafter at the same positions: a dense draft
over the prompt, the served tokens before the round and the round's own
drafts before each (``DRAFT_ROUNDS`` rounds of a request, drawn from the
seed), an EAGLE head followed round by round over every round of the
request (``reference.model.eagle_rounds``).  The number compared is the
90th percentile of those gaps (``draft_gap_p90``).  Beside them, every
request attempted must have finished cleanly with all its tokens.  Each
number is printed with its limit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from perfbench.harness import drafts as drafts_mod
from perfbench.reference import model as ref

SAMPLE = 6                 # requests judged a run
DRAFT_ROUNDS = 8           # rounds of a sampled request a dense draft judges


def pick(items: Sequence, seed: int, n: int = SAMPLE,
         request=lambda item: item) -> list:
    """``n`` of the finished requests (``request(item)`` of each item): the
    longest (prompt and output), and the rest drawn from the seed."""
    done = [it for it in items
            if request(it).output is not None and len(request(it).output)]
    if not done:
        return []

    def size(i):
        r = request(done[i])
        return len(r.prompt) + len(r.output)
    longest = max(range(len(done)), key=size)
    others = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 1 << 20])
    take = rng.choice(len(others), size=min(n - 1, len(others)),
                      replace=False) if others else []
    return [done[longest]] + [done[others[int(i)]] for i in sorted(take)]


def token_gaps(ref_logits, tokens):
    """The gap of each token below its row's best logit (0: the argmax)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.to(ref_logits.device)[:, None])[:, 0]
    return (best - got).cpu()


def _served(spec: dict, params: dict, seqs, precision: str):
    """Target hidden rows over every (prompt, served) pair, and the logits
    predicting its served tokens."""
    import torch
    dev = params["embed"]["table"].device
    toks = [torch.from_numpy(np.concatenate([p, o]).astype(np.int64)).to(dev)
            for p, o in seqs]
    lin = ref.Linear(precision)
    hs = ref.decoder_hidden(spec, params, toks, lin)
    logits = [ref.head_logits(spec, params, h[len(p) - 1: h.shape[0] - 1],
                              lin) for h, (p, _) in zip(hs, seqs)]
    return toks, hs, logits


def reference_gaps(spec: dict, params: dict,
                   seqs: Sequence[Tuple[np.ndarray, np.ndarray]],
                   precision: str = "fp32", drafter: Optional[dict] = None
                   ) -> Tuple[list, Optional[list]]:
    """For each (prompt, served) pair, the gap of every served token in the
    float32 reference, or, with ``precision="fp8"`` (the control), of the
    token the e4m3 reference puts first at the same position; and, with a
    ``drafter`` (``drafter_inputs``), the same of every judged draft (None
    without)."""
    import torch
    prev = ref.fp32_matmul_exact()
    try:
        with torch.no_grad():
            toks, hs, logits = _served(spec, params, seqs, "fp32")
            if precision == "fp32":
                served = [torch.from_numpy(o.astype(np.int64))
                          for _, o in seqs]
                hs_low = None
            else:
                _, hs_low, low = _served(spec, params, seqs, precision)
                served = [lg.argmax(-1).cpu() for lg in low]
                del low
            gaps = [token_gaps(lg, s) for lg, s in zip(logits, served)]
            del logits
            dgaps = None
            if drafter is not None:
                dgaps = _draft_gaps(spec, drafter, seqs, toks, hs, hs_low,
                                    precision)
            return gaps, dgaps
    finally:
        ref.restore_matmul(prev)


def drafter_inputs(dspec: dict, params: dict, traces: list, seed: int
                   ) -> dict:
    """What the drafter check reads: the drafter's sizes and weights, and
    for each sampled request its rounds (``drafts.trace``; None: none
    found), a dense draft's cut to ``DRAFT_ROUNDS`` drawn from the seed."""
    if dspec["kind"] == "model":
        rng = np.random.default_rng([int(seed) % (1 << 64), 1 << 21])
        cut = []
        for t in traces:
            if t is not None and len(t) > DRAFT_ROUNDS:
                keep = rng.choice(len(t), size=DRAFT_ROUNDS, replace=False)
                t = [t[int(i)] for i in sorted(keep)]
            cut.append(t)
        traces = cut
    return {"spec": dspec, "params": params, "traces": traces}


def _draft_gaps(spec, drafter, seqs, toks, hs, hs_low, precision) -> list:
    """Per sampled request, the gap of every judged draft in the float32
    reference drafter (with ``hs_low``, the control: of the token the e4m3
    drafter puts first at the same position)."""
    import torch
    dspec, params, traces = (drafter["spec"], drafter["params"],
                             drafter["traces"])
    out = []
    for i, (p, _) in enumerate(seqs):
        t = traces[i]
        if t is None:
            out.append(None)                  # the program's rounds not found
            continue
        if not t:
            out.append(torch.zeros(0))
            continue
        drafted = torch.from_numpy(
            np.concatenate([d for _, d in t]).astype(np.int64))
        if dspec["kind"] == "model":
            ctx = [torch.cat([toks[i][: len(p) + c],
                              torch.from_numpy(d.astype(np.int64))
                              .to(toks[i].device)]) for c, d in t]
            starts = [len(p) + c for c, _ in t]
            logits = torch.cat(ref.logits_at(dspec, params["draft"], ctx,
                                             starts))
            low = (torch.cat(ref.logits_at(dspec, params["draft"], ctx,
                                           starts, precision))
                   if hs_low is not None else None)
        else:
            head = {"heads": dspec["heads"], "kv_heads": dspec["kv_heads"],
                    "head_dim": dspec["head_dim"], "ff": dspec["ff"]}
            logits = ref.eagle_rounds(spec, head, params["target"],
                                      params["draft"], toks[i], hs[i],
                                      len(p), t)
            low = (ref.eagle_rounds(spec, head, params["target"],
                                    params["draft"], toks[i], hs_low[i],
                                    len(p), t, ref.Linear(precision))
                   if hs_low is not None else None)
        chosen = drafted if low is None else low.argmax(-1).cpu()
        out.append(token_gaps(logits, chosen))
    return out


def routes(spec: dict, params: dict, seqs: Sequence[np.ndarray]) -> list:
    """The experts the float32 reference routes every position of each
    token sequence to: ``[layer][sequence]`` (L, top_k)."""
    import torch
    dev = params["embed"]["table"].device
    toks = [torch.from_numpy(np.asarray(s, np.int64)).to(dev) for s in seqs]
    chosen: list = []
    prev = ref.fp32_matmul_exact()
    try:
        with torch.no_grad():
            ref.decoder_hidden(spec, params, toks, routes=chosen)
    finally:
        ref.restore_matmul(prev)
    return chosen


def judge(spec: dict, params: dict,
          seqs: Sequence[Tuple[np.ndarray, np.ndarray]], limits: dict, *,
          failed: int, short: int, drafter: Optional[dict] = None) -> dict:
    """The verdict: ``correct`` and each number beside its limit
    (``limits``: ``gap_p90``, and ``draft_gap_p90`` where the cell
    drafts; a missing limit fails)."""
    gaps, dgaps = (reference_gaps(spec, params, seqs, drafter=drafter)
                   if seqs else ([], None))
    checks = {"gap_p90": {"value": gap_p90(gaps),
                          "limit": limits.get("gap_p90")}}
    if drafter is not None:
        checks["draft_gap_p90"] = {
            "value": gap_p90(dgaps or []),
            "limit": limits.get("draft_gap_p90")}
    checks["requests_failed"] = {"value": failed, "limit": 0}
    checks["requests_short"] = {"value": short, "limit": 0}
    correct = bool(seqs) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return {"correct": bool(correct), "failed": failed, "checks": checks,
            "widest_gaps": [float(g.max()) for g in gaps],
            "tokens_judged": int(sum(g.numel() for g in gaps)),
            "drafts_judged": sum(int(g.numel()) for g in dgaps or []
                                 if g is not None)}


def gap_p90(gaps) -> float:
    """The 90th percentile of every sampled token's gap (linear between
    order statistics); infinite with nothing sampled, or with a request
    whose gaps never came (None)."""
    import torch
    if any(g is None for g in gaps):
        return float("inf")
    gaps = [g for g in gaps if g.numel()]
    if not gaps:
        return float("inf")
    return float(torch.cat(gaps).float().quantile(0.9))


def find_traces(rounds: list, seqs) -> list:
    """``drafts.trace`` of each sampled (prompt, served) pair in its unit's
    rounds (``rounds[i]``)."""
    return [drafts_mod.trace(r, o) for r, (_, o) in zip(rounds, seqs)]
