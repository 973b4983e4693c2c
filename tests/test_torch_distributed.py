"""The port's placement rules and mesh API against the reference's.

The rules are pure functions of a leaf's path and shape and of the mesh's
axis sizes: the port's spec tuples must equal ``tuple(PartitionSpec)`` of
the reference's (``repro.distributed.sharding``), here on a (2, 2)
("data", "model") mesh shape, which the reference reads from an
``AbstractMesh`` and the port from a mapping of axis sizes.  The cases of
tests/test_distributed.py's four rule tests come first, then every
parameter leaf of four reduced archs and every cache leaf kind.  A world
of two gloo ranks checks which expert block ``shard_params`` keeps; the
mesh API's contract (tests/test_expert_parallel.py::
test_mesh_api_validation_and_deprecation) runs on a world of one in this
process.
"""
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from _torch_ep_worlds import run_world
from _torch_parity import port_config
from repro.configs.registry import get_config
from repro.distributed import sharding as jsh
from repro.models.model import Model as JaxModel
from repro_torch.distributed import sharding as tsh
from repro_torch.models.model import Model

MESH = {"data": 2, "model": 2}


def _abstract(dims: dict):
    try:
        return AbstractMesh(tuple(dims.values()), tuple(dims))
    except TypeError:   # jax<=0.4.x signature: tuple of (name, size) pairs
        return AbstractMesh(tuple(dims.items()))


# tests/test_distributed.py's rule cases: (path, shape, fsdp, stacked,
# layout, the spec its test asserts on a (1, 1) mesh)
RULE_CASES = [
    # test_param_spec_rules
    ("layers/0/ffn/w_gate", (4, 16, 64, 128), True, True, "tp",
     P(None, "model", None, ("data",))),
    ("layers/1/mixer/wo", (4, 256, 128), False, True, "tp",
     P(None, "model", None)),
    ("final_norm/scale", (128,), False, False, "tp", P(None)),
    # test_fsdp_layout_rules
    ("layers/0/mixer/wq", (4, 256, 128), True, True, "fsdp",
     P(None, ("data", "model"), None)),
    ("layers/0/ffn/w_gate", (4, 16, 64, 128), True, True, "fsdp",
     P(None, "model", None, ("data",))),
    ("layers/0/ffn/w_down", (4, 128, 64), True, True, "fsdp",
     P(None, ("data", "model"), None)),
    # test_rank_disambiguates_dense_vs_expert_ffn
    ("layers/0/ffn/w_gate", (4, 64, 128), True, True, "tp",
     P(None, ("data",), "model")),
]


@pytest.mark.parametrize("path,shape,fsdp,stacked,layout,on_1x1", RULE_CASES)
def test_param_spec_rules_match_reference(path, shape, fsdp, stacked, layout,
                                          on_1x1):
    for dims in ({"data": 1, "model": 1}, MESH):
        kw = dict(fsdp=fsdp, stacked=stacked, layout=layout)
        want = jsh.param_spec(path, shape, mesh=_abstract(dims), **kw)
        assert tsh.param_spec(path, shape, mesh=dims, **kw) == tuple(want)
    assert tsh.param_spec(path, shape, mesh={"data": 1, "model": 1},
                          fsdp=fsdp, stacked=stacked,
                          layout=layout) == tuple(on_1x1)


@pytest.mark.parametrize("spec,shape", [(("model",), (7,)), (("model",), (8,)),
                                        (("model", None), (6, 3)),
                                        ((("data", "model"),), (8,)),
                                        ((("data", "model"),), (6,))])
def test_fit_drops_nondivisible(spec, shape):
    """test_fit_drops_nondivisible: a dim the axes' size does not divide
    stays whole."""
    for dims in ({"model": 2}, MESH):
        if "data" in str(spec) and "data" not in dims:
            continue
        want = jsh._fit(_abstract(dims), P(*spec), shape)
        assert tsh._fit(dims, spec, shape) == tuple(want)
    assert tsh._fit({"model": 2}, ("model",), (7,)) == (None,)
    assert tsh._fit({"model": 2}, ("model",), (8,)) == ("model",)


def _ref_leaves(cfg):
    """(path, shape) of every leaf of the reference's params (scan-stacked
    period slots), without computing them."""
    shapes = jax.eval_shape(lambda: JaxModel(cfg).init(jax.random.PRNGKey(0)))
    return {jsh._path_str(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("arch", ["qwen2-57b-a14b", "jamba-v0.1-52b",
                                  "xlstm-1.3b", "minicpm3-4b"])
@pytest.mark.parametrize("layout,fsdp", [("tp", False), ("tp", True),
                                         ("fsdp", True)])
def test_param_specs_of_every_leaf_match_reference(arch, layout, fsdp):
    """Port layer l is period l // period of the reference's slot
    l % period: its spec is the reference's stacked spec without the scan
    axis, leaf for leaf."""
    cfg = get_config(arch, reduced=True)
    ref = _ref_leaves(cfg)
    tcfg = port_config(cfg)
    params = Model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    specs = tsh._map_with_path(params, lambda p, leaf: tsh.param_spec(
        p, tuple(leaf.shape), mesh=MESH, fsdp=fsdp, stacked=False,
        layout=layout))
    n = 0
    for path, spec in _flat(specs):
        parts = path.split("/")
        if parts[0] == "layers":
            parts[1] = str(int(parts[1]) % tcfg.period)
        rpath = "/".join(parts)
        stacked = parts[0] == "layers"
        want = jsh.param_spec(rpath, ref[rpath], mesh=_abstract(MESH),
                              fsdp=fsdp, stacked=stacked, layout=layout)
        assert (((None,) + spec) if stacked else spec) == tuple(want), path
        n += 1
    assert n == len(_flat(specs)) > 10


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flat(v, f"{path}/{k}" if path else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{path}/{i}" if path else str(i))]
    return [(path, tree)]


# one case per leaf kind of cache_spec: (path, shape, kv_mode)
CACHE_CASES = [
    ("lengths", (8,), "auto"),
    ("pages/table", (8, 16), "auto"),
    ("layers/0/k_pages", (2, 64, 16, 4, 32), "auto"),
    ("layers/0/k_pages", (2, 64, 16, 3, 32), "auto"),
    ("layers/0/latent_pages", (2, 64, 16, 96), "auto"),
    ("layers/0/k", (2, 8, 128, 4, 32), "auto"),
    ("layers/0/v", (2, 8, 128, 3, 32), "auto"),
    ("layers/0/k", (2, 8, 128, 4, 32), "seq"),
    ("layers/0/v", (2, 8, 128, 3, 32), "heads"),
    ("layers/0/pos", (2, 8, 40), "auto"),
    ("layers/0/latent", (2, 8, 128, 96), "auto"),
    ("layers/0/k_rope", (2, 8, 128, 16), "auto"),
    ("layers/1/conv", (2, 8, 3, 256), "auto"),
    ("layers/1/ssm", (2, 8, 256, 16), "auto"),
    ("layers/2/C", (2, 8, 4, 33, 33), "auto"),
    ("layers/2/h", (2, 7, 128), "auto"),
    ("cross/0/k", (2, 8, 30), "auto"),
]


@pytest.mark.parametrize("path,shape,kv_mode", CACHE_CASES)
def test_cache_spec_matches_reference(path, shape, kv_mode):
    for dims in (MESH, {"data": 1, "model": 4}):
        want = jsh.cache_spec(path, shape, mesh=_abstract(dims),
                              kv_mode=kv_mode)
        assert tsh.cache_spec(path, shape, mesh=dims,
                              kv_mode=kv_mode) == tuple(want)


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_batch_spec_matches_reference(layout):
    """batch_sharding's rule: the batch dim over the data axes (every axis
    under fsdp) where they divide it."""
    tree = {"tokens": np.zeros((8, 16)), "embeds": np.zeros((6, 16, 4)),
            "odd": np.zeros((3, 5))}
    want = jsh.batch_sharding(jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model")),
        tree, layout)
    for k, leaf in tree.items():
        assert tsh.batch_spec({"data": 1, "model": 1}, leaf.shape,
                              layout) == tuple(want[k].spec), k
        ref = jsh._fit(_abstract(MESH), P(
            tuple(MESH) if layout == "fsdp" else ("data",),
            *([None] * (leaf.ndim - 1))), leaf.shape)
        assert tsh.batch_spec(MESH, leaf.shape, layout) == tuple(ref), k


def test_shard_params_keeps_each_ranks_block(tmp_path):
    """On a world of two ranks each expert leaf keeps the block of E/2
    experts of the rank's "model" coordinate; the router, the shared
    expert and the embedding stay whole (the same tensors)."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("router", (16, 8)), ("w_gate", (8, 16, 12)), ("w_up", (8, 16, 12)),
        ("w_down", (8, 12, 16)))}
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"p": (None, params, None)}, f)
    res = run_world(2, [("shard", "shard", dict(key="p", ep=2))],
                    str(tmp_path))
    for rank, r in enumerate(res):
        assert r["shard"]["rank_in_model"] == rank
        for path, leaf in r["shard"]["leaves"].items():
            k = path.split("/")[1]
            want = params[k] if k == "router" else \
                params[k][rank * 4:(rank + 1) * 4]
            np.testing.assert_array_equal(leaf, want, err_msg=path)
        assert r["shard"]["embed_is_same"]


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one in this process (make_ep_mesh starts it)."""
    from repro_torch.launch.mesh import make_ep_mesh
    return make_ep_mesh(1, device="cpu")


def test_mesh_api_validation_and_deprecation(world_of_one):
    """set_mesh is removed, resolve_mesh validates, make_ep_mesh and
    ServingEngine(mesh=...) refuse malformed meshes."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed.constraints import resolve_mesh, set_mesh
    from repro_torch.launch.mesh import make_ep_mesh, mesh_dims
    from repro_torch.serving.engine import ServingEngine

    mesh = world_of_one
    assert mesh_dims(mesh) == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="set_mesh was removed"):
        set_mesh(mesh)
    with pytest.raises(RuntimeError, match="mesh="):
        set_mesh(None)
    with pytest.raises(TypeError, match="Mesh"):
        resolve_mesh("not a mesh")
    with pytest.raises(ValueError, match="layout"):
        resolve_mesh(mesh, "bogus")
    with pytest.raises(ValueError, match="layout"):
        resolve_mesh(None, "bogus")
    m2, layout = resolve_mesh(mesh, "fsdp")
    assert m2 is mesh and layout == "fsdp"
    assert resolve_mesh(None, None) == (None, "tp")
    with pytest.raises(ValueError, match="degrees"):
        make_ep_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="needs 4096 ranks.*torchrun"):
        make_ep_mesh(4096, device="cpu")
    bad = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    cfg = ModelConfig("m", "dense", 1, 8, 1, 1, 16, 32, dtype="float32")
    with pytest.raises(ValueError, match="model"):
        ServingEngine(Model(cfg, device="cpu"), mesh=bad)


def test_ep_on_a_world_of_one_equals_gmm(world_of_one):
    """At ep 1 (the world the card runs) the all-to-all round trip returns
    every row to itself: the output is the gmm dispatch's, and a whole
    leaf is its own block (shard_params copies nothing)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.moe import init_moe, moe_forward
    cfg = ModelConfig("ep", "moe", 2, 64, 4, 2, 128, 256, num_experts=8,
                      num_experts_per_tok=2, moe_d_ff=128, dtype="float32",
                      num_shared_experts=1)
    p = init_moe(cfg, torch.float32, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, 64)).astype(np.float32))
    sharded = shard_params({"ffn": p}, world_of_one)["ffn"]
    assert all(sharded[k] is p[k] for k in ("w_gate", "w_up", "w_down"))
    before = collectives.EP_CALLS["moe_ep_forward"]
    y, m = moe_forward(p, cfg, x, dispatch="ep", mesh=world_of_one,
                       return_metrics=True)
    y_gmm, m_gmm = moe_forward(p, cfg, x, dispatch="gmm",
                               return_metrics=True)
    np.testing.assert_allclose(y.numpy(), y_gmm.numpy(), rtol=3e-4,
                               atol=3e-4)
    assert torch.equal(m["expert_counts"], m_gmm["expert_counts"])
    assert collectives.EP_CALLS["moe_ep_forward"] == before + 1


def test_serve_cli_ep_on_a_world_of_one(capsys):
    """--moe-dispatch ep --ep-degree 1 --device cpu serves through the
    all-to-all dispatch on a gloo world of one and prints the per-rank
    load of each wave (WaveReport.ep)."""
    from repro_torch.launch.serve import main
    reports = main(["--arch", "qwen2-57b-a14b", "--reduced", "--moe-dispatch",
                    "ep", "--ep-degree", "1", "--device", "cpu",
                    "--requests", "3", "--max-new", "4", "--no-autotune"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1}" in out and "dispatch=ep" in out
    assert reports and all(r.ep is not None and r.moe_dispatch == "ep"
                           for r in reports)
