"""The port's sharded train step against the reference's unsharded one.

On a spawned gloo world of 4 ranks as a (2, 2) ("data", "model") mesh,
one ``make_train_step`` step of the reduced ``qwen2-57b-a14b`` target
(fp32, remat, one-hot MoE dispatch) from params and moments placed with
``fsdp=True`` (``shard_params``, ``shard_opt_state``), under the "tp"
layout (Megatron splits over "model", FSDP over "data", the batch over
"data") and the "fsdp" layout (every dense leaf and the batch over both
axes).  The reference takes two steps from its init in this process; the
port's step starts from the reference's params and moments after the
first.  Each rank's blocks of the updated params and moments must equal
the reference's blocks of its second step, and the metrics its metrics,
to ``_torch_parity.assert_step_matches``'s tolerances: the masked mean
over the global token count, the load-balance loss over the whole batch,
gradients of replicas summed over the batch axes, the global norm with
each leaf counted once.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ep_worlds import join_world, start_world
from _torch_parity import CPU, port_config, to_np
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config
from repro.models.model import Model as JaxModel
from repro.training.optimizer import init_adam as jax_init_adam
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.distributed import sharding as tsh
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.training.tree import tree_items

CFG = get_config("qwen2-57b-a14b", reduced=True)
KW = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
DIMS = {"data": 2, "model": 2}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train"))
    rng = np.random.default_rng(0)
    B, T = 4, 16
    tokens = rng.integers(1, CFG.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 10:] = 0.0                     # ranks hold unequal token counts
    mask[3, 4:] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
             "mask": mask}
    jm = JaxModel(CFG, remat=True)
    step = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**KW)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jm.init(jax.random.PRNGKey(0))
    jp, jo, _ = step(jp, jax_init_adam(jp), jb)
    tcfg = port_config(CFG)
    p1 = params_from_jax(jax.device_get(jp), tcfg, CPU)
    o1 = opt_state_from_jax(jax.device_get(jo), tcfg, CPU)
    inp = {"train_cfg": dataclasses.asdict(tcfg), "train_kw": KW,
           "train_batch": batch,
           "train_state": (_np_tree(p1), [o1.step.numpy(), _np_tree(o1.mu),
                                          _np_tree(o1.nu)])}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    handle = start_world(4, [
        ("tp", "tp_train", dict(ep=2, data=2, layout="tp")),
        ("fsdp", "tp_train", dict(ep=2, data=2, layout="fsdp"))], tmp)
    jp2, jo2, jmet = step(jp, jo, jb)      # while the ranks run theirs
    world = join_world(handle)
    return {"world": world, "params": params_from_jax(
        jax.device_get(jp2), tcfg, CPU), "opt": opt_state_from_jax(
        jax.device_get(jo2), tcfg, CPU), "metrics": jmet}


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_sharded_step_equals_unsharded_reference(steps, layout):
    ref_p, ref_o, jmet = steps["params"], steps["opt"], steps["metrics"]
    lr = float(jmet["lr"])
    for r, res in enumerate(steps["world"]):
        got = res[layout]
        coords = {"data": r // 2, "model": r % 2}
        met = got["metrics"]
        for k in ("loss", "aux_loss", "grad_norm", "total_loss"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(met["lr"]), lr, rtol=5e-7)
        np.testing.assert_array_equal(met["expert_counts"],
                                      np.asarray(jmet["expert_counts"]))
        assert got["step"] == int(ref_o.step) == 2
        n_split = 0
        for name, tree, ref, rtol, atol in (
                ("mu", got["mu"], ref_o.mu, 1e-4, 1e-8),
                ("nu", got["nu"], ref_o.nu, 1e-4, 1e-12),
                ("params", got["params"], ref_p, 1e-6, 0.05 * lr)):
            for path, whole in tree_items(ref):
                spec = tsh.param_spec(path, tuple(whole.shape), mesh=DIMS,
                                      fsdp=True, stacked=False,
                                      layout=layout)
                want = tsh.take_block(whole, spec, DIMS, coords)
                n_split += want.shape != whole.shape
                np.testing.assert_allclose(tree[path], to_np(want),
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{layout} {name} {path}")
        assert n_split > 10          # the step really ran on blocks
