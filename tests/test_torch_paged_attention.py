"""Port's paged decode/verify attention against the reference, CPU.

Kernel level: the port's plain paged attention (what the wrapper runs for
CPU tensors, and what the CUDA kernel is held against on the card) equals
the reference's Pallas kernel in interpret mode and its jnp oracle, across
page sizes, verify widths and logit caps, on forked tables with poisoned
stale pages and on grown pools.  Write level: the paged write clamps a
logical page index past the table as the reference's gather does.  Token
level: greedy SD rounds on the reduced qwen2-57b-a14b (gmm dispatch) commit
the same tokens through the paged "kernel" path, the "gather" path and a
dense cache, and the same tokens as the reference engine, also across a
mid-stream pool growth.

fp32, TF32 off (``_torch_parity``); 2e-5 is the reference's own bound
(src/repro/kernels/decode_attention/decode_attention.py:288).
"""
from dataclasses import replace as dc_replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.configs.registry import get_config
from repro.core.proposer import ModelProposer as JaxModelProposer
from repro.core.spec_decode import SDEngine as JaxSDEngine
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.models import attention as jattn
from repro.models.model import Model as JaxModel
from repro.models.model import PageAllocator as JaxPageAllocator
from repro_torch.core.proposer import make_proposer
from repro_torch.core.spec_decode import SDEngine
from repro_torch.kernels.decode_attention import paged as tpaged
from repro_torch.kernels.decode_attention import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.model import PageAllocator

B, HQ, HKV, D, MP = 3, 4, 2, 16, 4
TOL = 2e-5


def _paged_case(seed: int, ps: int, T: int, d: int = D):
    """Random pool + bijective table + ragged lengths; every physical page
    (trash page included) is noise, so an unmasked stale read shows."""
    rng = np.random.default_rng(seed)
    pool_n = B * MP + 1
    k_pages = rng.normal(size=(pool_n, ps, HKV, d)).astype(np.float32)
    v_pages = rng.normal(size=(pool_n, ps, HKV, d)).astype(np.float32)
    table = rng.permutation(np.arange(1, pool_n)).reshape(B, MP)
    lengths = rng.integers(0, MP * ps - T + 1, size=B).astype(np.int32)
    q = rng.normal(size=(B, T, HQ, d)).astype(np.float32)
    return q, k_pages, v_pages, lengths, table.astype(np.int32)


def _port(q, k_pages, v_pages, lengths, table, cap=0.0):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k_pages, v_pages, lengths, table)]
    before = tpaged.LAUNCHES["paged_decode_attention"]
    out = tpaged.paged_decode_attention(*t, logit_cap=cap)
    assert tpaged.LAUNCHES["paged_decode_attention"] == before  # CPU: plain
    return out.numpy()


def _jax_kernel(q, k_pages, v_pages, lengths, table, cap=0.0):
    return np.asarray(jops.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k_pages, v_pages, lengths, table)),
        logit_cap=cap, interpret=True))


def _hold_paged_against_reference(seeds, ps: int, T: int, cap: float,
                                  d: int = D) -> None:
    """The port's plain version ≡ the reference's interpret-mode kernel ≡
    its paged oracle, in both layouts, for each seed."""
    for seed in seeds:
        case = _paged_case(seed, ps, T, d)
        q, kp, vp, lengths, table = case
        out = _port(*case, cap=cap)
        np.testing.assert_allclose(out, _jax_kernel(*case, cap=cap),
                                   rtol=TOL, atol=TOL)
        qh = q.transpose(0, 2, 1, 3)
        want = np.asarray(jref.paged_decode_attention_ref(
            *(jnp.asarray(a) for a in (qh, kp, vp, lengths, table)),
            logit_cap=cap))
        got = tref.paged_decode_attention_ref(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (qh, kp, vp, lengths, table)), logit_cap=cap)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, want.transpose(0, 2, 1, 3),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("T", [1, 3, 5, 8])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_plain_paged_attention_matches_reference_kernel(ps, T, cap):
    """The port's plain version ≡ the reference's interpret-mode kernel ≡
    its paged oracle, in both layouts, over two seeds."""
    _hold_paged_against_reference((ps * 10 + T, ps * 10 + T + 1), ps, T, cap)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("ps", [16, 64])
def test_plain_paged_attention_head_dim_256_matches_reference_kernel(ps, T,
                                                                     cap):
    """Head dim 256 (gemma3-12b's global layers; the split-KV body on the
    card) at a 2:1 grouping like gemma3's 16/8, pages of 16 and 64: the
    plain version ≡ the reference's interpret-mode kernel ≡ its oracle."""
    _hold_paged_against_reference((ps * 10 + T + 256,), ps, T, cap, d=256)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("ps,d", [(24, 128), (24, 256), (12, 128), (12, 256),
                                  (16, 32), (24, 32)])
def test_plain_paged_attention_odd_pages_and_head_dim_32_match_reference(
        ps, d, cap):
    """Pages that tile no 64-key chunk (24: TMA boxes of 8 rows on the card;
    12: chunks staged by cp.async) at head dims 128 and 256, and head dim 32
    (the reduced drafts'), at a 5-wide verify: the plain version the card's
    bodies are held against ≡ the reference's interpret-mode kernel ≡ its
    oracle."""
    _hold_paged_against_reference((ps * 10 + d,), ps, 5, cap, d=d)


@pytest.mark.parametrize("T", [16, 9])
def test_gathered_view_ignores_stale_nan_past_the_newest_query(T):
    """Extends wider than PAGED_KERNEL_MAX_T (a 16-token prefix-sharing
    tail, a gamma-8 verify of 9 queries) attend over the gathered
    ``pool[table]`` view.  When the rows' pages were recycled from a row
    whose K/V went NaN, every position past each row's newest query holds
    NaN: the port's output stays finite and equals the same extend over
    clean pages, and on clean pages it equals the reference's
    ``gqa_forward``.  The reference keeps the NaN on this path (a zero
    probability times a NaN V row in its P V product; ROADMAP queue 3), so
    it is held on the clean pages only."""
    from repro.configs.base import ModelConfig
    from repro_torch.models.convert import _map, _tensor
    from _torch_parity import port_config
    cfg = ModelConfig("pa-nan", "dense", 1, 64, 4, 2, 128, 256,
                      dtype="float32")
    tcfg = port_config(cfg)
    assert T > tattn.PAGED_KERNEL_MAX_T
    ps, mp, B = 8, 6, 2
    rng = np.random.default_rng(T)
    jp = jattn.init_gqa(jax.random.PRNGKey(T), cfg, jnp.float32)
    tp = _map(jax.device_get(jp), lambda a: _tensor(a, torch.device("cpu")))
    shape = (B * mp + 1, ps, cfg.num_kv_heads, cfg.head_dim)
    k_pages, v_pages = (rng.standard_normal(shape).astype(np.float32)
                        for _ in range(2))
    table = rng.permutation(np.arange(1, B * mp + 1)).reshape(B, mp).astype(
        np.int32)
    lengths = np.array([5, 20], np.int32)
    positions = lengths[:, None] + np.arange(T, dtype=np.int32)[None, :]
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    dirty = [a.copy() for a in (k_pages, v_pages)]
    for b in range(B):                         # NaN past the newest query
        for pos in range(int(positions[b, -1]) + 1, mp * ps):
            for a in dirty:
                a[table[b, pos // ps], pos % ps] = np.nan

    def port(kp, vp):
        cache = {"k_pages": torch.from_numpy(kp.copy()),
                 "v_pages": torch.from_numpy(vp.copy())}
        out, _ = tattn.gqa_forward(
            tp, tcfg, torch.from_numpy(x), torch.from_numpy(positions),
            cache=cache, mode="extend", page_table=torch.from_numpy(table))
        return out.numpy()

    clean, recycled = port(k_pages, v_pages), port(*dirty)
    assert np.isfinite(recycled).all()
    np.testing.assert_array_equal(recycled, clean)
    ref, _ = jattn.gqa_forward(
        jp, cfg, jnp.asarray(x), jnp.asarray(positions),
        cache={"k_pages": jnp.asarray(k_pages), "v_pages": jnp.asarray(v_pages)},
        mode="extend", page_table=jnp.asarray(table))
    np.testing.assert_allclose(clean, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_paged_attention_forked_tables_mask_stale_pages():
    """Rows 1..B-1 alias row 0's first two pages (a forked, many-to-one
    table) and every position past each row's length + T - 1, plus the
    trash page, holds huge garbage: the output equals the reference's and
    does not move under the poison."""
    ps, T = 8, 2
    q, kp, vp, lengths, table = _paged_case(3, ps, T)
    table = table.copy()
    table[1:, :2] = table[0, :2]
    lengths = np.array([2 * ps + 3, ps + 1, 2 * ps], np.int32)
    clean = _port(q, kp, vp, lengths, table)
    np.testing.assert_allclose(clean, _jax_kernel(q, kp, vp, lengths, table),
                               rtol=TOL, atol=TOL)
    pk, pv = kp.copy(), vp.copy()
    pk[0], pv[0] = 1e3, -1e3
    for b in range(B):
        first_dead = int(lengths[b]) + T
        for lp in range(MP):
            page = table[b, lp]
            lo = max(0, first_dead - lp * ps)
            if lo < ps and page not in table[0, :2]:  # keep shared live
                pk[page, lo:], pv[page, lo:] = 1e3, -1e3
    poisoned = _port(q, pk, pv, lengths, table)
    np.testing.assert_allclose(poisoned, clean, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(poisoned, _jax_kernel(q, pk, pv, lengths,
                                                     table),
                               rtol=TOL, atol=TOL)


def test_plain_paged_attention_invariant_under_pool_growth():
    """Fresh pool pages and trash table entries appended by a growth never
    perturb a live row."""
    ps, T = 16, 3
    q, kp, vp, lengths, table = _paged_case(11, ps, T)
    before = _port(q, kp, vp, lengths, table)
    extra = np.random.default_rng(12).normal(size=kp.shape).astype(np.float32)
    after = _port(q, np.concatenate([kp, extra]), np.concatenate([vp, -extra]),
                  lengths, np.pad(table, ((0, 0), (0, MP))))
    np.testing.assert_allclose(after, before, rtol=TOL, atol=TOL)


def test_paged_write_clamps_like_the_reference():
    """A frozen retired row (table all trash) whose positions run past the
    table, and a live row writing past its last page: the port's in-place
    write lands exactly where the reference's clamped gather sends it."""
    ps, NP = 4, 6
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(NP, ps, HKV, D)).astype(np.float32)
    table = np.array([[0, 0], [3, 5]], np.int32)          # MP = 2: 8 slots
    positions = np.array([[9, 10, 11], [6, 7, 8]], np.int32)
    vals = rng.normal(size=(2, 3, HKV, D)).astype(np.float32)
    want = np.asarray(jattn._paged_write(jnp.asarray(pool),
                                         jnp.asarray(table),
                                         jnp.asarray(positions),
                                         jnp.asarray(vals)))
    got = torch.from_numpy(pool.copy())
    tattn._paged_write(got, torch.from_numpy(table),
                       torch.from_numpy(positions.astype(np.int64)),
                       torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- token-level parity (SD)
TARGET = get_config("qwen2-57b-a14b", reduced=True)
DRAFT = get_config("qwen2-0.5b", reduced=True)
PS, POOL_MP = 8, 4                                    # max_seq = 32


@pytest.fixture(scope="module")
def pairs():
    jt, jpt, tm, tpt = model_pair(TARGET, seed=0, moe_dispatch="gmm")
    jd, jpd, dm, tpd = model_pair(DRAFT, seed=1)
    return (jpt, jd, jpd), (tm, tpt, dm, tpd)


def _prompts():
    return np.random.default_rng(4).integers(
        3, TARGET.vocab_size, (2, 6)).astype(np.int32)


def _grow(eng, state, alloc, max_seq, table_fn):
    state = eng.grow_session(state, 2 * max_seq,
                             pool_pages=2 * alloc.pool_pages,
                             max_pages=2 * POOL_MP)
    alloc.grow(2 * alloc.pool_pages, 2 * POOL_MP)
    for b in range(2):
        alloc.extend_row(b, 2 * max_seq)
    pages = dict(state.t_cache["pages"], table=table_fn(alloc.table))
    return dc_replace(state, t_cache=dict(state.t_cache, pages=pages))


def _port_trace(pair, *, paged_attention, paged, gamma, rounds=4,
                grow_at=None):
    tm, tpt, dm, tpd = pair
    tm.paged_attention = paged_attention
    eng = SDEngine(tm, make_proposer("model", tm, dm), gamma=max(gamma, 1))
    max_seq = POOL_MP * PS
    if paged:
        alloc = PageAllocator(2, PS, 2 * POOL_MP + 1, POOL_MP)
        for b in range(2):
            alloc.alloc(b, max_seq)
        state = eng.start(tpt, tpd, _prompts(), max_seq=max_seq,
                          cache_opts={"paged": True, "page_size": PS,
                                      "pool_pages": alloc.pool_pages},
                          page_table=alloc.table)
    else:
        state = eng.start(tpt, tpd, _prompts(), max_seq=2 * max_seq)
    trace = [state.last_token.numpy().copy()]
    for r in range(rounds):
        if paged and grow_at == r:
            state = _grow(eng, state, alloc, max_seq,
                          lambda t: torch.tensor(t, dtype=torch.int32))
        state, res = eng.round(state, gamma=gamma)
        for b in range(2):
            trace.append(res.committed[b, : res.n_commit[b]].copy())
    tm.paged_attention = "kernel"
    return trace


def _jax_trace(jpair, *, gamma, rounds=4, grow_at=None):
    """The reference engine's greedy trace through its paged kernel."""
    jpt, jd, jpd = jpair
    t = JaxModel(TARGET, moe_dispatch="gmm", paged_attention="kernel")
    eng = JaxSDEngine(t, JaxModelProposer(t, jd), gamma=max(gamma, 1))
    max_seq = POOL_MP * PS
    alloc = JaxPageAllocator(2, PS, 2 * POOL_MP + 1, POOL_MP)
    for b in range(2):
        alloc.alloc(b, max_seq)
    state = eng.start(jpt, jpd, jnp.asarray(_prompts()), max_seq=max_seq,
                      key=jax.random.PRNGKey(7),
                      cache_opts={"paged": True, "page_size": PS,
                                  "pool_pages": alloc.pool_pages},
                      page_table=jnp.asarray(alloc.table))
    trace = [np.asarray(state.last_token).copy()]
    for r in range(rounds):
        if grow_at == r:
            state = _grow(eng, state, alloc, max_seq, jnp.asarray)
        state, res = eng.round(state, gamma=gamma,
                               key=jax.random.PRNGKey(100 + r))
        for b in range(2):
            trace.append(res.committed[b, : res.n_commit[b]].copy())
    return trace


def _assert_same(*traces):
    for steps in zip(*traces):
        for other in steps[1:]:
            np.testing.assert_array_equal(steps[0], other)


@pytest.mark.parametrize("gamma", [0, 1, 4])
def test_sd_rounds_token_identical_kernel_gather_dense_and_reference(
        pairs, gamma):
    """Greedy SD rounds commit the same tokens through the paged kernel
    path, the gather path and a dense cache, and the reference's."""
    jpair, pair = pairs
    kernel = _port_trace(pair, paged_attention="kernel", paged=True,
                         gamma=gamma)
    gather = _port_trace(pair, paged_attention="gather", paged=True,
                         gamma=gamma)
    dense = _port_trace(pair, paged_attention="kernel", paged=False,
                        gamma=gamma)
    _assert_same(kernel, gather, dense, _jax_trace(jpair, gamma=gamma))


def test_sd_rounds_token_identical_across_growth(pairs):
    """A mid-stream pool growth (grow_session + allocator extend): the
    grown kernel and gather sessions stay token-identical to a dense
    session sized for the final capacity and to the reference's grown
    session."""
    jpair, pair = pairs
    kernel = _port_trace(pair, paged_attention="kernel", paged=True,
                         gamma=2, rounds=6, grow_at=3)
    gather = _port_trace(pair, paged_attention="gather", paged=True,
                         gamma=2, rounds=6, grow_at=3)
    dense = _port_trace(pair, paged_attention="kernel", paged=False,
                        gamma=2, rounds=6)
    _assert_same(kernel, gather, dense,
                 _jax_trace(jpair, gamma=2, rounds=6, grow_at=3))
