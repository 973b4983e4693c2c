"""What the drafter proposed in each round of the timed path, for the check.

``Recorder(session)`` wraps two methods of one of the program's decoding
sessions (``repro_torch.core.spec_decode.SDEngine``), on that object alone:

* its proposer's ``propose`` copies the drafts into a buffer of the
  harness's own.  The copy runs inside the round, so a captured round graph
  holds it and every replay writes the buffer;
* its ``round`` appends, once the round is back on the host, the round's
  live rows, committed tokens and the buffer (a (B, gamma) copy to the host
  after the round's own readback) to ``rounds``.

Install it before the session's first round, so that every graph captures
the copy.  Which request a row served is not recorded: ``trace`` finds it
from the tokens served.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Round:
    active: np.ndarray                 # (B,) bool: rows the round decoded
    n_commit: np.ndarray               # (B,) tokens each row committed
    committed: np.ndarray              # (B, g + 1) the committed tokens
    drafts: np.ndarray                 # (B, g) what the drafter proposed


class Recorder:
    def __init__(self, session):
        self.rounds: List[Round] = []
        self._bufs: Dict[Tuple[int, ...], object] = {}
        prop = session.proposer
        propose, round_ = prop.propose, session.round

        def recorded_propose(params, state, last_token, gamma, generator):
            drafts, q_dist, work = propose(params, state, last_token, gamma,
                                           generator)
            buf = self._bufs.get(tuple(drafts.shape))
            if buf is None:
                buf = self._bufs[tuple(drafts.shape)] = drafts.clone()
            buf.copy_(drafts)
            return drafts, q_dist, work

        def recorded_round(state, **kw):
            state, res = round_(state, **kw)
            B, g = res.committed.shape[0], res.committed.shape[1] - 1
            buf = self._bufs.get((B, g))
            active = kw.get("active")
            self.rounds.append(Round(
                np.ones(B, bool) if active is None
                else np.asarray(active, bool).copy(),
                np.asarray(res.n_commit).copy(),
                np.asarray(res.committed).copy(),
                buf.cpu().numpy().copy() if buf is not None
                else np.zeros((B, g), np.int64)))
            return state, res

        prop.propose = recorded_propose
        session.round = recorded_round


def trace(rounds: List[Round], output: np.ndarray
          ) -> Optional[List[Tuple[int, np.ndarray]]]:
    """The rounds that served ``output`` (the first token comes from the
    prefill), as (c, drafts): c of its tokens were served before the round,
    and the row's drafts.  The row is the one whose committed tokens spell
    the output on, round after round; None when no row did."""
    n = len(output)
    if n < 2:
        return []
    for k, first in enumerate(rounds):
        rows = np.nonzero(first.active & (first.n_commit > 0)
                          & (first.committed[:, 0] == output[1]))[0]
        for b in rows:
            got, pos = [], 1
            for rd in rounds[k:]:
                m = int(rd.n_commit[b])
                w = min(m, n - pos)
                if not rd.active[b] or m == 0 or not np.array_equal(
                        rd.committed[b, :w], output[pos: pos + w]):
                    break
                got.append((pos, rd.drafts[b].copy()))
                pos += m
                if pos >= n:
                    return got
    return None
