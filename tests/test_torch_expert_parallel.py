"""The port's expert parallelism against the reference's, on CPU worlds.

The port's EP runs on worlds of gloo ranks spawned from this module
(``_torch_ep_worlds.py``: 2, 4 and 8 ranks, each world spawned once and
running all of its cases).  The reference's ``moe_ep_forward`` and mesh
``warm_experts`` need a multi-device mesh, which jax gets only from
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before import:
they run once, in one subprocess, on the same numpy inputs, as
tests/test_expert_parallel.py runs them.  The reference's single-device SD
rounds and continuous stream run in this process.

Tolerance 3e-4 in fp32, the reference's own EP bound
(tests/test_expert_parallel.py, test_ep_dispatch.py): the top-k combine
sums in another order; greedy tokens must be identical.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_ep_worlds import run_world
from _torch_parity import port_config, to_np
from repro.configs.base import ModelConfig
from repro_torch.models.convert import _map

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-4, atol=3e-4)

CFG = ModelConfig("ep", "moe", 2, 64, 4, 2, 128, 256, num_experts=8,
                  num_experts_per_tok=2, moe_d_ff=128, dtype="float32",
                  num_shared_experts=1)
CFG_NS = CFG.with_overrides(num_shared_experts=0)
TCFG = ModelConfig("ep-t", "moe", 2, 64, 4, 2, 128, 256, num_experts=8,
                   num_experts_per_tok=2, dtype="float32")
DCFG = ModelConfig("ep-d", "dense", 2, 32, 2, 2, 64, 256, dtype="float32")

_ORACLE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ModelConfig
    from repro.distributed.collectives import moe_ep_forward
    from repro.launch.mesh import make_ep_mesh
    from repro.models import moe as moe_mod

    tmp = sys.argv[1]
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)

    def ep(key, mesh, **kw):
        # jitted, as the reference's callers run it (eager shard_map runs
        # the interpret-mode kernels op by op)
        cfg, p, x = inp[key]
        cfg = ModelConfig(**cfg)
        return np.asarray(jax.jit(lambda p, x: moe_ep_forward(
            p, cfg, x, mesh=mesh, **kw))(J(p), jnp.asarray(x)))

    out = {}
    for key in ("bias", "plain", "skew"):
        cfg, p, x = inp[key]
        out[key, "onehot"] = np.asarray(moe_mod.moe_forward(
            J(p), ModelConfig(**cfg), jnp.asarray(x), dispatch="onehot")[0])
    for e, dd in ((2, 1), (4, 2), (8, 1)):
        out["bias", e, dd] = ep("bias", make_ep_mesh(e, data_degree=dd))
    out["plain", 2, 1, 8.0] = ep("plain", make_ep_mesh(2),
                                 capacity_factor=8.0)
    out["skew", 2, 1, 0.5] = ep("skew", make_ep_mesh(2),
                                capacity_factor=0.5)
    cfg, p, x = inp["fsdp"]
    cfg, p, x = ModelConfig(**cfg), J(p), jnp.asarray(x)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out["fsdp", "onehot"] = np.asarray(
        moe_mod.moe_forward(p, cfg, x, dispatch="onehot")[0])
    out["fsdp", 2, 2] = np.asarray(jax.jit(lambda p, x: moe_mod.moe_forward(
        p, cfg, x, dispatch="ep", mesh=mesh, mesh_layout="fsdp"))(p, x)[0])
    cfg, layers, ids = inp["warm"]
    cfg = ModelConfig(**cfg)
    stacked = [{"ffn": {k: jnp.stack([jnp.asarray(l[k]) for l in layers])
                        for k in ("w_gate", "w_up", "w_down")}}]
    plan = moe_mod.PrefetchPlan(
        masks=(jnp.zeros((len(layers), cfg.num_experts), bool),),
        expert_ids=(jnp.asarray(np.stack(ids)),))
    (w,) = moe_mod.warm_experts(stacked, cfg, plan, mesh=make_ep_mesh(8))
    out["warm"] = {k: np.asarray(v) for k, v in w.items()}
    with open(os.path.join(tmp, "oracle.pkl"), "wb") as f:
        pickle.dump(out, f)
    print("OK")
""")


def _moe_params(rng, cfg, *, router_bias=None):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def w(*shape):                     # fan-in scaled, fp32
        return (rng.standard_normal(shape)
                / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
         "w_down": w(E, f, d)}
    if router_bias is not None:
        p["router"] = p["router"] + router_bias
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs),
                       "w_down": w(fs, d)}
    return p


def _inputs() -> dict:
    import dataclasses
    from repro.models.model import Model
    rng = np.random.default_rng(0)
    asd = dataclasses.asdict
    E = CFG.num_experts
    # experts 5..7 pushed away (the reference's bias): empty local
    # experts, and empty ranks at ep 8
    bias = np.zeros((1, E), np.float32)
    bias[:, 5:] = -100.0
    # most pairs to experts 0-1 (rank 0 at ep 2): drops at a small factor
    skew = np.zeros((1, E), np.float32)
    skew[:, :2] = 3.0
    warm_cfg = CFG_NS
    jt, jd = Model(TCFG), Model(DCFG)
    return {
        # 14 rows: the pad-to-an-even-split path on 4 and 8 ranks
        "bias": (asd(CFG), _moe_params(rng, CFG, router_bias=bias),
                 rng.standard_normal((2, 7, 64)).astype(np.float32)),
        "plain": (asd(CFG), _moe_params(rng, CFG),
                  rng.standard_normal((2, 7, 64)).astype(np.float32)),
        "skew": (asd(CFG), _moe_params(rng, CFG, router_bias=skew),
                 rng.standard_normal((2, 16, 64)).astype(np.float32)),
        "fsdp": (asd(CFG_NS), _moe_params(rng, CFG_NS),
                 (rng.standard_normal((4, 16, 64)) * 0.5).astype(np.float32)),
        "warm": (asd(warm_cfg),
                 [_moe_params(rng, warm_cfg) for _ in range(2)],
                 [rng.choice(E, 3, replace=False).astype(np.int32)
                  for _ in range(2)]),
        "tcfg": asd(TCFG), "dcfg": asd(DCFG),
        "pt": jax.device_get(jt.init(jax.random.PRNGKey(0))),
        "pd": jax.device_get(jd.init(jax.random.PRNGKey(1))),
    }


def _port_gmm(cfg, params, x):
    """The port's single-device gmm dispatch (the plain kernels here)."""
    import torch
    from repro_torch.models.moe import moe_forward
    y, _ = moe_forward(_map(params, torch.from_numpy),
                       port_config(ModelConfig(**cfg)), torch.from_numpy(x),
                       dispatch="gmm")
    return to_np(y)


def _reference_runs(inp):
    """The reference's single-device (gmm) SD rounds and continuous
    stream, from the same params."""
    import jax.numpy as jnp
    from repro.core.proposer import make_proposer
    from repro.core.spec_decode import SDEngine
    from repro.models.model import Model
    from repro.serving.engine import ServingEngine
    from repro.serving.faults import ResilienceConfig
    pt = jax.tree_util.tree_map(jnp.asarray, inp["pt"])
    pd = jax.tree_util.tree_map(jnp.asarray, inp["pd"])
    t, d = Model(TCFG, moe_dispatch="gmm"), Model(DCFG)
    eng = SDEngine(t, make_proposer("model", t, d), gamma=4)
    prompts = (np.arange(24).reshape(4, 6) % 250 + 1).astype(np.int32)
    state = eng.start(pt, pd, prompts, max_seq=64)
    rows = [np.asarray(state.last_token).tolist()]
    for g in (4, 0, 4, 4, 0):
        state, res = eng.round(state, gamma=g)
        rows.append((res.n_commit.tolist(),
                     [res.committed[b, :res.n_commit[b]].tolist()
                      for b in range(4)]))
    seng = ServingEngine(t, d, pt, pd, max_batch=3, gamma=2, force_sd=True,
                         scheduler="continuous", kv_layout="paged",
                         page_size=8, seed=0,
                         resilience=ResilienceConfig(max_pool_pages=8))
    ua = seng.submit(np.arange(3, 9), max_new_tokens=16)
    ub = seng.submit(np.arange(4, 10), max_new_tokens=8, arrival_round=1)
    uc = seng.submit(np.arange(5, 11), max_new_tokens=8, arrival_round=2)
    seng.run()
    assert seng.fault_counters["preemptions"] >= 1    # the cap really binds
    return rows, [seng.done[u].output.tolist() for u in (ua, ub, uc)]


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """Every world's results, the oracle's and the reference's runs."""
    tmp = str(tmp_path_factory.mktemp("ep"))
    inp = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    oracle = subprocess.Popen([sys.executable, "-c", _ORACLE, tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(REPO))
    try:
        worlds = {
            2: run_world(2, [
                ("bias", "dispatch", dict(key="bias", ep=2)),
                ("cap8", "dispatch", dict(key="plain", ep=2,
                                          capacity_factor=8.0)),
                ("skew", "dispatch", dict(key="skew", ep=2,
                                          capacity_factor=0.5,
                                          sharded=False))], tmp),
            4: run_world(4, [
                ("fsdp", "dispatch", dict(key="fsdp", ep=2, data=2,
                                          layout="fsdp"))], tmp),
            8: run_world(8, [
                ("bias_4x2", "dispatch", dict(key="bias", ep=4, data=2)),
                ("bias_8x1", "dispatch", dict(key="bias", ep=8,
                                              sharded=False)),
                ("shard_4x2", "shard", dict(key="bias", ep=4, data=2,
                                            layout="fsdp")),
                ("warm", "warm", dict(ep=8, sharded=True)),
                ("warm_whole", "warm", dict(ep=8, sharded=False)),
                ("sd", "sd_rounds", dict(ep=8)),
                ("stream", "stream", dict(ep=8))], tmp),
        }
        ref_rows, ref_stream = _reference_runs(inp)
        stdout, stderr = oracle.communicate(timeout=600)
    finally:
        if oracle.poll() is None:
            oracle.kill()
    assert oracle.returncode == 0 and "OK" in stdout, stderr[-3000:]
    with open(os.path.join(tmp, "oracle.pkl"), "rb") as f:
        ref = pickle.load(f)
    return {"in": inp, "worlds": worlds, "ref": ref, "ref_rows": ref_rows,
            "ref_stream": ref_stream, "port_gmm": {
                key: _port_gmm(*inp[key]) for key in ("bias", "skew")}}


def _same_on_every_rank(results, name, key):
    first = results[0][name][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[name][key], first)
    return first


@pytest.mark.parametrize("world,name,mesh", [
    (2, "bias", (2, 1)), (8, "bias_4x2", (4, 2)), (8, "bias_8x1", (8, 1))])
def test_dispatch_matches_reference_ep_and_gmm(ep, world, name, mesh):
    """Empty experts and empty ranks (experts 5-7 never routed to), 14 rows
    over 2, 8 and 8 ranks (the padded split), a shared expert: the port's
    EP equals the reference's moe_ep_forward at the same mesh, its one-hot
    and gmm dispatches, and the port's own moe_forward(dispatch="ep")."""
    res = ep["worlds"][world]
    y = _same_on_every_rank(res, name, "y")
    ref = ep["ref"]
    np.testing.assert_allclose(y, ref[("bias",) + mesh], **TOL)
    np.testing.assert_allclose(y, ep["port_gmm"]["bias"], **TOL)
    np.testing.assert_allclose(y, ref["bias", "onehot"], **TOL)
    np.testing.assert_array_equal(res[0][name]["y_moe_forward"], y)
    assert all(r[name]["ep_calls"] == 2 for r in res)


def test_expert_counts_sum_to_routed_pairs(ep):
    """moe_forward(dispatch="ep", return_metrics=True) counts N·K routed
    pairs (test_ep_dispatch.py)."""
    N = 2 * 7
    for world, name in ((2, "bias"), (8, "bias_4x2"), (8, "bias_8x1")):
        counts = _same_on_every_rank(ep["worlds"][world], name,
                                     "expert_counts")
        assert counts.sum() == N * CFG.num_experts_per_tok


def test_capacity_factor_8_is_exact(ep):
    y = _same_on_every_rank(ep["worlds"][2], "cap8", "y")
    np.testing.assert_allclose(y, ep["ref"]["plain", 2, 1, 8.0], **TOL)
    np.testing.assert_allclose(y, ep["ref"]["plain", "onehot"], **TOL)


def test_small_capacity_drops_the_reference_pairs(ep):
    """A skewed routing (most pairs to rank 0's experts) at capacity factor
    0.5: slots overflow, the same pairs drop as in the reference (its
    output differs from the drop-free one-hot), and the port's whole
    leaves are sliced in the dispatch."""
    res = ep["worlds"][2]
    y = _same_on_every_rank(res, "skew", "y")
    ref = ep["ref"]
    assert np.abs(ref["skew", 2, 1, 0.5] - ref["skew", "onehot"]).max() > 1e-2
    np.testing.assert_allclose(y, ref["skew", 2, 1, 0.5], **TOL)
    assert res[0]["skew"]["w_gate_rows"] == CFG.num_experts


def test_fsdp_layout_matches_reference(ep):
    """test_ep_dispatch.py's fsdp-layout case on a (2, 2) mesh."""
    y = _same_on_every_rank(ep["worlds"][4], "fsdp", "y")
    np.testing.assert_allclose(y, ep["ref"]["fsdp", 2, 2], **TOL)
    np.testing.assert_allclose(y, ep["ref"]["fsdp", "onehot"], **TOL)


def test_shard_params_keeps_the_rank_block_on_2x4(ep):
    """On a (2, 4) mesh under the fsdp layout each rank keeps the
    contiguous block of E/4 experts of its "model" coordinate (rank r at
    (r // 4, r % 4)); other leaves stay whole (test_torch_distributed.py
    holds the (1, 2) mesh)."""
    _, params, _ = ep["in"]["bias"]
    e_local = CFG.num_experts // 4
    for rank, res in enumerate(ep["worlds"][8]):
        j = res["shard_4x2"]["rank_in_model"]
        assert j == rank % 4
        for path, leaf in res["shard_4x2"]["leaves"].items():
            k = path.split("/")[1]
            want = (params[k] if k == "router"
                    else params[k][j * e_local:(j + 1) * e_local])
            np.testing.assert_array_equal(leaf, want, err_msg=path)
        assert res["shard_4x2"]["embed_is_same"]


@pytest.mark.parametrize("name", ["warm", "warm_whole"])
def test_warm_experts_under_a_mesh_matches_reference(ep, name):
    """Each rank's warm buffers equal the reference's shard of its mesh
    branch: its own predicted experts gathered, the others zeroed."""
    ref = ep["ref"]["warm"]
    for rank, res in enumerate(ep["worlds"][8]):
        for layer, bufs in enumerate(res[name]):
            for k, v in bufs.items():
                np.testing.assert_array_equal(v, ref[k][rank, layer],
                                              err_msg=f"{rank} {layer} {k}")


def test_sd_rounds_token_identical_on_ep8(ep):
    """Greedy SD rounds at gamma 4 and 0 on an ep-8 world commit the
    reference's single-device gmm tokens."""
    for res in ep["worlds"][8]:
        assert res["sd"]["rows"] == ep["ref_rows"]
        assert res["sd"]["engine_mesh"]
        assert res["sd"]["expert_rows"] == TCFG.num_experts // 8


def test_continuous_stream_preemption_and_warm_guards_on_ep8(ep):
    """The continuous paged stream (in-flight admission, page-pressure
    preemption) on an ep-8 world is token-identical to the reference's
    single-device stream, reports 8 per-rank loads, leaks no page, and the
    same stream again on the warm engine runs no new round key or
    admission shape and one input signature a round key."""
    for res in ep["worlds"][8]:
        s = res["stream"]
        assert s["first"] == ep["ref_stream"]
        assert s["again"] == s["first"]
        assert s["preemptions"] >= 1
        assert len(s["ep"]["per_shard_load"]) == 8
        assert s["ep"]["imbalance"] >= 1.0
        assert s["ep"]["a2a_bytes_per_device"] > 0
        assert s["compile_count"] == 0
        assert s["sharding_programs"] > 0 and s["sharding_ok"], s["render"]
        assert s["expert_rows"] == TCFG.num_experts // 8
