"""The port's tensor-parallel placement and serving against the reference.

On spawned gloo worlds (``_torch_ep_worlds.py``) of 2 and 4 ranks, over
the reduced ``qwen2-57b-a14b`` target (EP dispatch) and the reduced
``qwen2-0.5b`` draft, every leaf placed as ``ServingEngine`` places it:

  * (1, 2): every split lines up with whole heads;
  * (1, 4): the target's ``wk`` block is half a head and its 2 KV heads
    do not divide 4, so its dense cache splits along the sequence
    (``max_seq`` 64 divides by 4) and attention merges per-rank partials;
  * (2, 2): data x model, the batch of a cache split over ``"data"``.

Each rank holds exactly the block the reference's ``param_spec`` /
``cache_spec`` give (shapes for every reduced arch under both layouts;
the order of the blocks of a dim split over ("data", "model") against the
reference's ``NamedSharding.devices_indices_map`` on a forced 4-device
mesh in one subprocess).  Greedy SD rounds and the continuous paged
stream are token-identical to the reference's single-device run, and the
serving steps' fp32 logits agree within 1e-4 (the reduction order of
*g*'s all-reduce and the log-sum-exp merge differ from one device's).
The reference runs in this process, never in a spawned rank.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_ep_worlds import join_world, start_world
from _torch_parity import port_config
from repro.configs.registry import _REDUCED, get_config
from repro.distributed import sharding as jsh
from repro.models.model import Model as JaxModel
from repro_torch.distributed import sharding as tsh

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_BS = (4, 64)
MAX_SEQ = 64
TARGET = get_config("qwen2-57b-a14b", reduced=True)
DRAFT = get_config("qwen2-0.5b", reduced=True)

# the reference's blocks of (path, shape) leaves on a forced (2, 2) mesh
_ORACLE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro.distributed.sharding import param_spec
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for path, shape, fsdp, layout in pickle.loads(bytes.fromhex(sys.argv[1])):
        spec = param_spec(path, shape, mesh=mesh, fsdp=fsdp, stacked=False,
                          layout=layout)
        idx = NamedSharding(mesh, spec).devices_indices_map(shape)
        devs = list(mesh.devices.flat)          # rank r = (r // 2, r % 2)
        out[path, fsdp, layout] = [
            [(s.start or 0, s.stop if s.stop is not None else n)
             for s, n in zip(idx[d], shape)] for d in devs]
    print(pickle.dumps(out).hex())
""")
ORDER_CASES = [("layers/0/mixer/wq", (256, 256), True, "fsdp"),
               ("layers/0/ffn/w_gate", (4, 256, 128), True, "fsdp"),
               ("layers/0/ffn/w_gate", (4, 256, 128), True, "tp"),
               ("layers/0/mixer/wo", (256, 256), True, "tp"),
               ("embed/table", (512, 256), True, "tp")]


def _abstract(dims: dict):
    try:
        return AbstractMesh(tuple(dims.values()), tuple(dims))
    except TypeError:   # jax<=0.4.x signature: tuple of (name, size) pairs
        return AbstractMesh(tuple(dims.items()))


def _ints(*shape, lo=1, hi=500, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _inputs() -> dict:
    asd = lambda c: dataclasses.asdict(port_config(c))
    return {
        "archs": [(n, asd(_REDUCED[n]())) for n in sorted(_REDUCED)],
        "cache_bs": CACHE_BS, "max_seq": MAX_SEQ,
        "tcfg": asd(TARGET), "dcfg": asd(DRAFT),
        "pt": _params(TARGET, 0), "pd": _params(DRAFT, 1),
        "prompts": (np.arange(24).reshape(4, 6) % 250 + 1).astype(np.int32),
        "verify": (_ints(4, 8, seed=1), _ints(4, 5, seed=2)),
        "arch_steps": _arch_inputs(), "arch_max_seq": ARCH_MAX_SEQ,
    }


# the other block kinds under a mesh (serve steps only): Mamba + attention
# + MoE, a sliding-window ring (split along its slots at m 4), MLA (its
# latent split along the sequence), mLSTM and sLSTM states, and whisper's
# encoder and cross-attention
ARCH_STEPS = ("jamba-v0.1-52b", "gemma3-12b", "minicpm3-4b", "xlstm-1.3b",
              "whisper-base")
ARCH_MAX_SEQ = 32


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _params(cfg, seed: int) -> dict:
    """Random params in the reference's layout (each period slot's layers
    stacked), drawn by the port's init, which is far quicker on the CPU
    than the reference's; ``params_from_jax`` reads them back."""
    from repro_torch.models.model import Model
    p = Model(port_config(cfg), device="cpu").init(
        torch.Generator().manual_seed(seed))
    p = jax.tree_util.tree_map(lambda t: t.numpy(), p)

    def slots(layers, period):
        return [_stack(layers[s::period]) for s in range(period)]

    p["layers"] = slots(p["layers"], cfg.period)
    if "encoder" in p:
        p["encoder"]["layers"] = slots(p["encoder"]["layers"], 1)
    return p


def _arch_inputs() -> list:
    out = []
    for i, name in enumerate(ARCH_STEPS):
        cfg = get_config(name, reduced=True)
        frames = None
        if cfg.is_encoder_decoder:
            frames = np.random.default_rng(i).standard_normal(
                (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append((name, dataclasses.asdict(port_config(cfg)),
                    _params(cfg, 10 + i),
                    (_ints(2, 8, hi=cfg.vocab_size, seed=20 + i),
                     _ints(2, 5, hi=cfg.vocab_size, seed=30 + i), frames)))
    return out


def _reference_arch_steps(inp) -> dict:
    from repro.serving import serve_step
    out = {}
    for name, _, jparams, (tokens, tail, frames) in inp["arch_steps"]:
        cfg = get_config(name, reduced=True)
        m = JaxModel(cfg)
        p = jax.tree_util.tree_map(jnp.asarray, jparams)
        kw = {} if frames is None else {"encoder_embeds": jnp.asarray(frames)}
        cache = m.init_cache(tokens.shape[0], ARCH_MAX_SEQ)
        last, cache = serve_step.make_prefill_step(m)(p, jnp.asarray(tokens),
                                                      cache, **kw)
        logits, cache = serve_step.make_verify_step(m, 4)(
            p, jnp.asarray(tail), jnp.full((2,), 3, jnp.int32), cache)
        dec, _ = serve_step.make_decode_step(m)(p, jnp.asarray(tail[:, 0]),
                                                cache)
        out[name] = {"prefill": np.asarray(last), "verify": np.asarray(logits),
                     "decode": np.asarray(dec)}
    return out


def _reference(inp) -> dict:
    """The reference's single-device runs: SD rounds, the continuous paged
    stream, and the serving steps' logits."""
    from repro.core.proposer import make_proposer
    from repro.core.spec_decode import SDEngine
    from repro.serving import serve_step
    from repro.serving.engine import ServingEngine
    from repro.serving.faults import ResilienceConfig
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    pt, pd = J(inp["pt"]), J(inp["pd"])
    t, d = JaxModel(TARGET, moe_dispatch="gmm"), JaxModel(DRAFT)
    out = {}
    prompts, tail = inp["verify"]
    cache = t.init_cache(prompts.shape[0], MAX_SEQ)
    last, cache = serve_step.make_prefill_step(t)(pt, jnp.asarray(prompts),
                                                  cache)
    logits, cache = serve_step.make_verify_step(t, 4)(
        pt, jnp.asarray(tail), jnp.full((4,), 3, jnp.int32), cache)
    dec, cache = serve_step.make_decode_step(t)(pt, jnp.asarray(tail[:, 0]),
                                                cache)
    out.update(prefill=np.asarray(last), verify=np.asarray(logits),
               decode=np.asarray(dec), lengths=np.asarray(cache["lengths"]))
    eng = SDEngine(t, make_proposer("model", t, d), gamma=4)
    state = eng.start(pt, pd, inp["prompts"], max_seq=MAX_SEQ)
    rows = [np.asarray(state.last_token).tolist()]
    for g in (4, 0, 4, 4, 0):
        state, res = eng.round(state, gamma=g)
        rows.append((res.n_commit.tolist(),
                     [res.committed[b, :res.n_commit[b]].tolist()
                      for b in range(4)]))
    out["rows"] = rows
    for key, pool in (("stream", 3), ("stream4", 4)):
        seng = ServingEngine(t, d, pt, pd, max_batch=pool, gamma=2,
                             force_sd=True, scheduler="continuous",
                             kv_layout="paged", page_size=8, seed=0,
                             resilience=ResilienceConfig(max_pool_pages=8))
        ua = seng.submit(np.arange(3, 9), max_new_tokens=16)
        ub = seng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1)
        uc = seng.submit(np.arange(5, 11), max_new_tokens=8, arrival_round=2)
        seng.run()
        out[key] = [seng.done[u].output.tolist() for u in (ua, ub, uc)]
    return out


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    oracle = subprocess.Popen(
        [sys.executable, "-c", _ORACLE, pickle.dumps(ORDER_CASES).hex()],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO))
    try:
        # both worlds run while this process runs the reference
        handles = {
            2: start_world(2, [
                ("shapes", "tp_shapes", dict(ep=2)),
                ("serve", "tp_serve", dict(ep=2)),
                ("serve_fsdp", "tp_serve", dict(ep=2, layout="fsdp",
                                                stream=False)),
                ("archs", "tp_arch_steps", dict(ep=2))], tmp),
            4: start_world(4, [
                ("shapes", "tp_shapes", dict(ep=4)),
                ("shapes22", "tp_shapes", dict(ep=2, data=2)),
                ("serve", "tp_serve", dict(ep=4)),
                ("serve22", "tp_serve", dict(ep=2, data=2, stream_batch=4)),
                ("archs", "tp_arch_steps", dict(ep=4))], tmp),
        }
        ref = _reference(inp)
        ref["archs"] = _reference_arch_steps(inp)
        worlds = {w: join_world(h) for w, h in handles.items()}
        stdout, stderr = oracle.communicate(timeout=300)
    finally:
        if oracle.poll() is None:
            oracle.kill()
    assert oracle.returncode == 0, stderr[-3000:]
    return {"in": inp, "worlds": worlds, "ref": ref,
            "order": pickle.loads(bytes.fromhex(stdout.strip()))}


# ------------------------------------------------------------------ shapes
def _block(shape, spec, dims):
    return tuple(n // jsh._axis_size(_abstract(dims), e) if e is not None
                 else n for n, e in zip(shape, tuple(spec) + (None,) *
                                        len(shape)))


def _want_params(cfg, dims, fsdp, layout) -> dict:
    ref = {jsh._path_str(p): tuple(l.shape) for p, l in
           jax.tree_util.tree_flatten_with_path(jax.eval_shape(
               lambda: JaxModel(cfg).init(jax.random.PRNGKey(0))))[0]}
    tcfg = port_config(cfg)
    from repro_torch.models.model import Model
    port = Model(tcfg, device="meta").init(torch.Generator())
    from repro_torch.training.tree import tree_items
    out = {}
    for path, leaf in tree_items(port):
        parts = path.split("/")
        stacked = parts[0] == "layers" or (parts[0] == "encoder"
                                           and parts[1] == "layers")
        if stacked:
            i = 1 if parts[0] == "layers" else 2
            parts[i] = str(int(parts[i]) % (tcfg.period if i == 1 else 1))
        rpath = "/".join(parts)
        spec = jsh.param_spec(rpath, ref[rpath], mesh=_abstract(dims),
                              fsdp=fsdp, stacked=stacked, layout=layout)
        blk = _block(ref[rpath], spec, dims)
        out[path] = blk[1:] if stacked else blk
    return out


def _want_cache(cfg, dims, paged) -> dict:
    B, S = CACHE_BS
    tcfg = port_config(cfg)
    from repro_torch.models.model import Model
    port = Model(tcfg, device="meta").init_cache(B, S, paged=paged,
                                                 page_size=16)
    ref = {jsh._path_str(p): tuple(l.shape) for p, l in
           jax.tree_util.tree_flatten_with_path(jax.eval_shape(
               lambda: JaxModel(cfg).init_cache(B, S, paged=paged,
                                                page_size=16)))[0]}
    out = {}
    from repro_torch.training.tree import tree_items
    for path, leaf in tree_items(port):
        shape = tuple(leaf.shape)
        parts = path.split("/")
        if parts[0] == "layers":
            parts[1] = str(int(parts[1]) % tcfg.period)
            rpath = "/".join(parts)
            rshape = ref[rpath]
        elif parts[0] == "cross":        # written by prefill, no init
            rpath, rshape = path, (1,) + shape
        else:
            rpath, rshape = path, shape
        spec = jsh.cache_spec(rpath, rshape, mesh=_abstract(dims))
        blk = _block(rshape, spec, dims)
        if parts[0] in ("layers", "cross"):
            blk = blk[1:]
            if len(shape) >= 2 and shape[1] == rshape[2] + 1:   # trash slot
                blk = (blk[0], blk[1] + 1) + blk[2:]
        out[path] = blk
    return out


@pytest.mark.parametrize("world,case,dims", [
    (2, "shapes", {"data": 1, "model": 2}),
    (4, "shapes", {"data": 1, "model": 4}),
    (4, "shapes22", {"data": 2, "model": 2})])
def test_every_leaf_is_the_reference_block(tp, world, case, dims):
    """Params (serving and training placement, both layouts), moments and
    caches (dense, paged): each rank's shape is the block of the
    reference's spec, for every reduced arch."""
    n = 0
    for name, _ in tp["in"]["archs"]:
        cfg = _REDUCED[name]()
        for layout in ("tp", "fsdp"):
            for fsdp in (False, True):
                want = _want_params(cfg, dims, fsdp, layout)
                for res in tp["worlds"][world]:
                    got = res[case][name, layout, "params", fsdp]
                    assert got == want, (name, layout, fsdp)
                    n += 1
            for res in tp["worlds"][world]:
                assert res[case][name, layout, "mu"] == _want_params(
                    cfg, dims, True, layout), (name, layout)
                for kind, paged in (("cache", False), ("paged", True)):
                    got = res[case].get((name, layout, kind))
                    if got is None:             # whisper: no paged cache
                        continue
                    # the rows its CachePlacement says the rank holds
                    B, di = CACHE_BS[0], res[case]["coords"].get("data", 0)
                    assert got.pop("placement") == (
                        None if dims["data"] == 1 else
                        (di * B // dims["data"], B // dims["data"]))
                    assert got == _want_cache(cfg, dims, paged), \
                        (name, layout, kind)
    assert n > 0


@pytest.mark.parametrize("case", ORDER_CASES)
def test_block_order_matches_named_sharding(tp, case):
    """A dim split over ("data", "model") orders its blocks with "data"
    major: each rank's block bounds equal the reference's
    ``devices_indices_map`` on a (2, 2) mesh (rank r at (r // 2, r % 2))."""
    path, shape, fsdp, layout = case
    dims = {"data": 2, "model": 2}
    spec = tsh.param_spec(path, shape, mesh=dims, fsdp=fsdp, stacked=False,
                          layout=layout)
    for r, want in enumerate(tp["order"][path, fsdp, layout]):
        coords = {"data": r // 2, "model": r % 2}
        got = []
        for n, e in zip(shape, spec):
            if e is None:
                got.append((0, n))
                continue
            i, k = tsh.block_index(e, dims, coords)
            got.append((i * n // k, (i + 1) * n // k))
        assert got == [tuple(b) for b in want], (case, r)


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("world,case", [(2, "serve"), (2, "serve_fsdp"),
                                        (4, "serve"), (4, "serve22")])
def test_serve_steps_match_reference(tp, world, case):
    """Prefill, a gamma-4 verify and a decode step through
    ``serving/serve_step`` on every rank: the whole batch's fp32 logits
    within 1e-4 of the reference's single device, the same lengths (a
    rank of (2, 2) holds its data group's rows of them)."""
    ref = tp["ref"]
    for res in tp["worlds"][world]:
        r = res[case]
        for k in ("prefill", "verify", "decode"):
            np.testing.assert_allclose(r[k], ref[k], **TOL, err_msg=k)
        n = len(r["lengths"])
        di = r["coords"]["data"]
        np.testing.assert_array_equal(r["lengths"],
                                      ref["lengths"][di * n:(di + 1) * n])


def test_placement_on_each_mesh(tp):
    """What the serving cases ran on: the target's ``wq`` and the vocab
    split over "model" under "tp" (half a KV head's ``wk`` at m 4), whole
    under "fsdp" serving; the cache's KV heads split at m 2, its
    sequence at m 4 (16 of 64 positions and a trash slot), its batch over
    "data" at (2, 2)."""
    H, hd, V = TARGET.num_heads * TARGET.head_dim, TARGET.head_dim, \
        TARGET.vocab_size
    w2, w4 = tp["worlds"][2], tp["worlds"][4]
    for r in w2:
        assert r["serve"]["wq"] == (TARGET.d_model, H // 2)
        assert r["serve"]["embed"] == (V // 2, TARGET.d_model)
        assert r["serve"]["cache_k"] == (4, MAX_SEQ + 1, 1, hd)
        assert r["serve_fsdp"]["wq"] == (TARGET.d_model, H)
        assert r["serve_fsdp"]["cache_k"] == (4, MAX_SEQ + 1, 1, hd)
    for r in w4:
        assert r["serve"]["wq"] == (TARGET.d_model, H // 4)
        assert r["serve"]["cache_k"] == (4, MAX_SEQ // 4 + 1, 2, hd)
        assert r["serve22"]["cache_k"] == (2, MAX_SEQ + 1, 1, hd)


@pytest.mark.parametrize("world,case", [(2, "serve"), (2, "serve_fsdp"),
                                        (4, "serve"), (4, "serve22")])
def test_sd_rounds_token_identical(tp, world, case):
    """Greedy SD rounds at gamma 4 and 0 commit the reference's tokens on
    (1, 2) under both layouts, on (1, 4), and on (2, 2), where each data
    group runs half the batch and the logits are gathered before
    rejection."""
    for res in tp["worlds"][world]:
        assert res[case]["rows"] == tp["ref"]["rows"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCH_STEPS)
def test_other_block_kinds_serve_steps_match_reference(tp, world, arch):
    """Prefill, verify and decode of the other block kinds with every leaf
    and the cache placed: fp32 logits within 1e-4 of the reference's."""
    ref = tp["ref"]["archs"][arch]
    for res in tp["worlds"][world]:
        for k in ("prefill", "verify", "decode"):
            np.testing.assert_allclose(res["archs"][arch][k], ref[k], **TOL,
                                       err_msg=f"{arch} {k}")


@pytest.mark.parametrize("world,case,ref,m", [
    (2, "serve", "stream", 2), (4, "serve", "stream", 4),
    (4, "serve22", "stream4", 2)])
def test_continuous_paged_stream_token_identical(tp, world, case, ref, m):
    """The continuous paged stream (admissions, preemption under a
    capped pool) through ``ServingEngine(mesh=...)``, which places both
    models and keeps the draft's cache whole; on (2, 2) a pool of 4 slots
    splits the rows of the table and lengths over "data" while every rank
    writes every row's pages into its whole pool."""
    for res in tp["worlds"][world]:
        s = res[case]
        assert s["stream"] == tp["ref"][ref]
        assert s["stream_embed"] == (TARGET.vocab_size // m, TARGET.d_model)
        assert s["draft_cache_whole"]
