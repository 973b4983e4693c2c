"""The port's dry-run tools on the meta device against the reference.

``launch/specs.py``: ``arch_for_shape`` equals the reference's for every
registered arch x input shape, and ``input_specs``' shapes and dtypes
equal ``jax.eval_shape`` of the reference's (the cache read through the
port's layout: one leaf per layer, a trash slot on dense K/V, cross K/V
slots from the start).  ``launch/roofline.py`` under ``V5E`` gives the
reference's fields.  ``launch/dryrun.py``: the per-rank weight bytes of
``qwen2-57b-a14b`` equal ``scripts/tp_placement_bytes.py``'s; the
collective census of a one-layer decode at m 2 holds two all-reduces of
the hidden states; the counter's FLOPs equal ``FlopCounterMode``'s; a
recurrence counted by one repeated step equals the step-by-step loop;
and the whole CLI runs with neither ``jax`` nor ``repro`` imported and no
tensor off the meta device.  Under ``gmm`` and ``ep`` (a stated uniform
routing) the counts are held against plain counts of the port's own
operations: the meta FLOPs equal a real CPU step's, the ``ep`` census
equals the padded buffers sent.  The reference's HLO-parser tests have no
counterpart: the port emits no HLO.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config, registered
from repro_torch.core.simulator import V5E
from repro_torch.kernels.gmm import ragged
from repro_torch.launch import costs, dryrun, roofline, specs
from repro_torch.launch.costs import StepCounter
from repro_torch.models import ssm
from repro_torch.models.model import Model
from repro_torch.serving.serve_step import (make_prefill_step,
                                            make_verify_step)
from repro_torch.training.tree import tree_items

REPO = Path(__file__).resolve().parents[1]
GB = 1e9
# scripts/tp_placement_bytes.py's per-rank weight bytes of qwen2-57b-a14b
# under "tp", m 2 / 4 / 8 (PERF.md section 4), GB
TP_WEIGHT_GB = {2: 57.43, 4: 28.73, 8: 14.38}
_TRASH = ("k", "v", "latent", "k_rope")


def test_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(REF_SHAPES[name])


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_arch_for_shape_matches_reference(shape):
    for arch in registered():
        for gamma in (0, 4):
            got = specs.arch_for_shape(arch, INPUT_SHAPES[shape], gamma)
            want = ref_specs.arch_for_shape(arch, REF_SHAPES[shape], gamma)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch


def _port_leaves(tree, cfg, prefix=""):
    """{reference path: {(shape, dtype)}} of the port's inputs: a layer's
    cache leaf under the reference's stacked path (layer l of a period
    of p at slot l % p), without a dense leaf's trash slot."""
    out = {}
    for path, t in tree_items(tree):
        parts = path.split("/")
        shape = tuple(t.shape)
        if parts[0] == "cache" and parts[1] in ("layers", "cross"):
            slot = tree[parts[0]][parts[1]][int(parts[2])]
            if parts[1] == "layers" and parts[3] in _TRASH \
                    and "pos" not in slot:
                shape = (shape[0], shape[1] - 1) + shape[2:]
            parts[2] = str(int(parts[2]) % cfg.period)
        out.setdefault("/".join(parts), set()).add(
            (shape, str(t.dtype).replace("torch.", "")))
    return out


def _ref_leaves(tree, cfg):
    """The same of the reference's abstract inputs, a stacked leaf's
    period axis taken off (and held to num_periods)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for kp, s in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        shape = tuple(s.shape)
        if parts[0] == "cache" and parts[1] in ("layers", "cross"):
            assert shape[0] == cfg.num_periods, parts
            shape = shape[1:]
        out["/".join(parts)] = {(shape, str(s.dtype))}
    return out


@pytest.mark.parametrize("arch", ["qwen2-57b-a14b", "gemma3-12b",
                                  "whisper-base", "jamba-v0.1-52b",
                                  "minicpm3-4b"])
def test_input_specs_match_reference(arch):
    for shape_name in INPUT_SHAPES:
        for gamma in ((0, 4) if INPUT_SHAPES[shape_name].kind == "decode"
                      else (0,)):
            shape = INPUT_SHAPES[shape_name]
            cfg = specs.arch_for_shape(arch, shape, gamma)
            model = Model(cfg, device="meta")
            got = specs.input_specs(cfg, shape, model, gamma)
            rcfg = ref_specs.arch_for_shape(arch, REF_SHAPES[shape_name],
                                            gamma)
            want = jax.eval_shape(lambda: ref_specs.input_specs(
                rcfg, REF_SHAPES[shape_name], JaxModel(rcfg), gamma))
            port, ref = _port_leaves(got, cfg), _ref_leaves(want, rcfg)
            assert all(t.device.type == "meta" for _, t in tree_items(got))
            # the port's cache holds an encoder-decoder's cross K/V slots
            # from the start; the reference's prefill cache has none
            extra = {p for p in port if p not in ref}
            assert all(p.startswith("cache/cross/") and shape.kind ==
                       "prefill" for p in extra), (shape_name, extra)
            for path, leaves in ref.items():
                assert port.get(path) == leaves, (shape_name, gamma, path)


def test_input_specs_refuses_a_model_off_meta():
    cfg = get_config("qwen2-7b", reduced=True)
    with pytest.raises(ValueError, match="meta"):
        specs.input_specs(cfg, INPUT_SHAPES["decode_32k"],
                          Model(cfg, device="cpu"))


def test_roofline_analyze_matches_reference_on_v5e():
    rec = {
        "arch": "qwen2-7b", "shape": "decode_32k", "mesh": "16x16",
        "devices": 256, "gamma": 0,
        "params": ref_get_config("qwen2-7b").param_count(),
        "active_params": ref_get_config("qwen2-7b").active_param_count(),
        "flops_per_device": 1e9, "bytes_per_device": 1e9,
        "collective_bytes_per_device": {"all-gather": 0, "all-reduce": 1e6,
                                        "reduce-scatter": 0, "all-to-all": 0,
                                        "collective-permute": 0, "total": 1e6},
        "memory": {"temp_bytes": int(4e9)},
    }
    assert roofline.analyze(rec, hw=V5E) == ref_roofline.analyze(rec)
    h100 = roofline.analyze(rec)
    assert "fits_80gb" in h100 and "fits_16gb" not in h100
    assert h100["t_memory_s"] < ref_roofline.analyze(rec)["t_memory_s"]


def _tp_placement_bytes():
    spec = importlib.util.spec_from_file_location(
        "tp_placement_bytes", REPO / "scripts" / "tp_placement_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_weight_bytes_per_rank_match_the_placement_script():
    script = _tp_placement_bytes()
    cfg = get_config("qwen2-57b-a14b")
    for m, gb in TP_WEIGHT_GB.items():
        rec = dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                                 dims={"data": 1, "model": m})
        got = rec["memory"]["resident_bytes"]["params"]
        r = script.rank_bytes(cfg, m, "tp")
        assert got == r["experts"] + r["rest"], m
        assert round(got / GB, 2) == gb, (m, got / GB)
        assert rec["real_tensors"] == 0


def test_one_layer_decode_census_holds_two_all_reduces_a_layer():
    """qwen2-7b cut to one layer at m 2: the attention's and the FFN's
    row-parallel outputs are all-reduced, each (B, 1, d) bf16 on this
    rank, inside the stack; the vocab-parallel embedding's all-reduce and
    the head's all-gather of the logits blocks outside it."""
    cfg = get_config("qwen2-7b")
    B = INPUT_SHAPES["decode_32k"].global_batch
    rec = dryrun.count_combo("qwen2-7b", "decode_32k",
                             dims={"data": 1, "model": 2},
                             extra_overrides={"num_layers": 1})
    coll = rec["collective_bytes_per_device"]
    hidden = B * cfg.d_model * 2
    assert coll["in_loop"] == 2 * hidden
    assert coll["all-reduce"] == 3 * hidden          # + the embedding's
    assert coll["all-gather"] == B * (cfg.vocab_size // 2) * 2
    assert coll["outside"] == coll["total"] - coll["in_loop"]
    assert rec["collective_bytes_by_axis"] == {"model": coll["total"]}


def test_dryrun_contract_in_process():
    """tests/test_dryrun_cli.py's assertions on the port's record."""
    rec = dryrun.count_combo("whisper-base", "decode_32k")
    rec["status"] = "ok"
    json.dumps(rec)
    assert rec["status"] == "ok"
    assert rec["devices"] == 8 and rec["mesh"] == "1x8"
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] >= 0
    assert {"in_loop", "outside"} <= set(rec["collective_bytes_per_device"])
    assert {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute", "total"} <= set(
                rec["collective_bytes_per_device"])
    assert rec["memory"]["peak_bytes"] > 0
    assert rec["real_tensors"] == 0


def test_dryrun_refuses_data_dependent_dispatch():
    """gmm and ep, whose groups follow the routing, are counted on the
    stated uniform routing with no tensor off the meta device; a dispatch
    the dry-run does not know is still refused."""
    for dispatch in ("gmm", "ep"):
        rec = dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                                 moe_dispatch=dispatch,
                                 extra_overrides={"num_layers": 2})
        assert rec["real_tensors"] == 0
        assert rec["knobs"]["routing"] == "uniform"
        assert rec["knobs"]["moe_dispatch"] == dispatch
        assert "dispatch_ran" not in rec["knobs"]
    rec = dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                             extra_overrides={"num_layers": 2})
    assert "routing" not in rec["knobs"]
    with pytest.raises(ValueError, match="counts"):
        dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                           moe_dispatch="capacity")


def test_stated_group_sizes_are_uniform_and_real():
    got = costs.stated_group_sizes(torch.empty((5,), dtype=torch.int32,
                                               device="meta"), 23)
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert got.tolist() == [5, 5, 5, 4, 4]
    few = costs.stated_group_sizes(specs.meta((8,), torch.int32), 3)
    assert few.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]
    real = torch.tensor([3, 0, 1], dtype=torch.int32)
    assert costs.stated_group_sizes(real, 99) is real


def test_ragged_kernels_count_their_work_on_meta():
    """Each ragged product on the meta device records 2·rows·D·F FLOPs a
    weight and moves the rows of x, the weights of every expert with a
    row, the sizes and the output rows once; it launches nothing, and
    still refuses an input that requires grad, and meta group sizes."""
    N, D, F, E = 40, 16, 24, 4
    xs = specs.meta((N, D), torch.bfloat16)
    wg, wu = specs.meta((E, D, F), torch.bfloat16), \
        specs.meta((E, D, F), torch.bfloat16)
    wd = specs.meta((E, F, D), torch.bfloat16)
    sizes = torch.tensor([10, 0, 20, 6], dtype=torch.int32)
    rows, active = 36, 3
    before = dict(ragged.LAUNCHES)
    c = StepCounter()
    with c:
        h = ragged.fused_gate_up(xs, wg, wu, sizes)
    assert h.is_meta and h.shape == (N, F) and h.dtype == torch.bfloat16
    assert c.flops == 2 * 2 * rows * D * F
    assert c.bytes == (rows * D * 2 + active * 2 * D * F * 2 + E * 4
                       + rows * F * 2)
    c = StepCounter()
    with c:
        y = ragged.ragged_moe_ffn(xs, wg, wu, wd, sizes)
    assert y.shape == (N, D) and c.flops == 3 * 2 * rows * D * F
    assert c.real == 0 and dict(ragged.LAUNCHES) == before
    with pytest.raises(ValueError, match="stated_group_sizes"):
        ragged.ragged_gmm(xs, wg, specs.meta((E,), torch.int32))
    with pytest.raises(RuntimeError, match="no backward"):
        ragged.ragged_gmm(xs, wg.requires_grad_(), sizes)


@pytest.mark.parametrize("arch", ["qwen2-57b-a14b", "mixtral-8x7b"])
def test_gmm_meta_flops_equal_the_cpu_count(arch):
    """The reduced verify step under gmm counted on the meta device (the
    stated routing) and run on real CPU tensors through the plain loop
    (the routing of random weights) gives the same FLOPs: the ragged
    products' depend on N·K alone."""
    cfg = get_config(arch, reduced=True)
    B, T, S = 2, 5, 64
    counts = {}
    for dev in ("meta", "cpu"):
        model = Model(cfg, moe_dispatch="gmm", device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                             dtype=torch.int32).to(dev)
        n = torch.full((B,), 3, dtype=torch.int32, device=dev)
        cache = model.init_cache(B, S)
        counts[dev] = _count(lambda: make_verify_step(model, T - 1)(
            params, toks, n, cache), params)
    assert counts["meta"].real == 0 and counts["cpu"].real > 0
    assert counts["meta"].flops == counts["cpu"].flops > 0


def _expert_flops(monkeypatch):
    got = []
    record = costs.record_kernel
    monkeypatch.setattr(costs, "record_kernel",
                        lambda flops, nbytes: (got.append(flops),
                                               record(flops, nbytes)))
    return got


@pytest.mark.parametrize("dims,gamma", [({"model": 2}, 0),
                                        ({"data": 2, "model": 2}, 0),
                                        ({"data": 2, "model": 2}, 4)])
def test_ep_census_equals_the_issued_buffers(dims, gamma, monkeypatch):
    """One MoE layer of qwen2-57b-a14b under ep: the all-to-all census is
    the two hops' padded slot buffers and the expert ids, as sent
    (drop-free: N_loc·K slots a destination), and the ragged products run
    the N_loc·K pairs this rank receives under the uniform routing."""
    cfg = get_config("qwen2-57b-a14b")
    shape = INPUT_SHAPES["decode_32k"]
    flops = _expert_flops(monkeypatch)
    rec = dryrun.count_combo("qwen2-57b-a14b", "decode_32k", gamma=gamma,
                             moe_dispatch="ep", dims=dims,
                             extra_overrides={"num_layers": 1})
    m, d, f = dims["model"], cfg.d_model, cfg.moe_d_ff
    K = cfg.num_experts_per_tok
    n_local = shape.global_batch * (gamma + 1) // (m * dims.get("data", 1))
    slots = n_local * K
    coll = rec["collective_bytes_per_device"]
    assert coll["all-to-all"] == 2 * m * slots * d * 2 + m * slots * 4
    assert sum(flops) == 6 * n_local * K * d * f
    assert rec["real_tensors"] == 0 and rec["knobs"]["routing"] == "uniform"


def test_ep_falls_back_to_onehot_where_experts_do_not_divide():
    rec = dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                             moe_dispatch="ep", dims={"model": 2},
                             extra_overrides={"num_layers": 1,
                                              "num_experts": 7,
                                              "num_experts_per_tok": 2})
    assert rec["knobs"]["dispatch_ran"] == "onehot"
    assert "routing" not in rec["knobs"]
    assert rec["collective_bytes_per_device"]["all-to-all"] == 0


def test_ep_decode_of_the_full_target_on_one_node():
    """qwen2-57b-a14b decode_32k on "1x8": 28 layers of two 7,340,032-byte
    hops and 4,096 bytes of expert ids; the all-gathers are the outputs'
    and the non-expert ones onehot issues too, without its expert blocks."""
    ep = dryrun.count_combo("qwen2-57b-a14b", "decode_32k",
                            moe_dispatch="ep")
    one = dryrun.count_combo("qwen2-57b-a14b", "decode_32k")
    cfg = get_config("qwen2-57b-a14b")
    ce, co = (r["collective_bytes_per_device"] for r in (ep, one))
    assert ce["all-to-all"] == 411_156_480 and co["all-to-all"] == 0
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    expert_blocks = cfg.num_layers * 3 * (E // 8) * d * f * 2
    out_gathers = cfg.num_layers * 16 * d * 2
    assert ce["all-gather"] == co["all-gather"] - expert_blocks + out_gathers
    assert ep["memory"]["peak_bytes"] < one["memory"]["peak_bytes"]
    assert ep["flops_per_device"] < one["flops_per_device"]


@pytest.mark.parametrize("dispatch", ["gmm", "ep"])
def test_train_under_ragged_dispatch_stops_at_the_refusal(dispatch, capsys):
    assert dryrun.main(["--arch", "qwen2-57b-a14b", "--shape", "train_4k",
                        "--moe-dispatch", dispatch]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["status"] == "fail"
    assert "no backward" in rec["error"]


def _count(step, pinned):
    c = StepCounter()
    c.pin(pinned)
    with c:
        step()
    return c


@pytest.mark.parametrize("arch,kind", [("qwen2-57b-a14b", "verify"),
                                       ("gemma3-12b", "prefill")])
def test_counter_flops_equal_flop_counter_mode(arch, kind):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="meta")
    params = model.init(torch.Generator())
    B, T, S = 2, 5 if kind == "verify" else 48, 64
    toks = specs.meta((B, T), torch.int32)
    n = specs.meta((B,), torch.int32)
    if kind == "verify":
        step = lambda: make_verify_step(model, T - 1)(  # noqa: E731
            params, toks, n, model.init_cache(B, S))
    else:
        step = lambda: make_prefill_step(model)(  # noqa: E731
            params, toks, model.init_cache(B, S), lengths=n)
    with FlopCounterMode(display=False) as fc:
        step()
    c = _count(step, params)
    assert c.flops == fc.get_total_flops() > 0
    assert c.bytes > 0 and c.peak > 0 and c.real == 0


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_counted_recurrence_equals_the_loop(arch, monkeypatch):
    """A 32-step prefill counted by one step repeated gives the loop's
    FLOPs and bytes exactly."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="meta")
    params = model.init(torch.Generator())
    B, T = 2, 32
    toks, lens = specs.meta((B, T), torch.int32), specs.meta((B,), torch.int32)
    step = lambda: make_prefill_step(model)(  # noqa: E731
        params, toks, model.init_cache(B, T), lengths=lens)
    counted = _count(step, params)
    monkeypatch.setattr(ssm, "_scan_counted",
                        lambda run, carry, xs, consts: ssm._scan_loop(
                            run, carry, xs, False, consts))
    loop = _count(step, params)
    assert (counted.flops, counted.bytes) == (loop.flops, loop.bytes)
    assert counted.flops > 0


def test_cli_imports_neither_jax_nor_the_reference():
    code = ("import runpy, sys, json, io, contextlib\n"
            "sys.argv = ['dryrun', '--arch', 'whisper-base', '--shape', "
            "'decode_32k']\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            "    try:\n"
            "        runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps({'line': buf.getvalue().strip().splitlines()"
            "[-1], 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    rec = json.loads(out["line"])
    assert rec["status"] == "ok" and rec["devices"] == 8
    assert rec["real_tensors"] == 0
