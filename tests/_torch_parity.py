"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX reference
and the port.  fp32 parity runs with TF32 off: it does not apply on the CPU,
and is switched off so the same comparisons keep full fp32 on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.model import Model as JaxModel
from repro.training.optimizer import init_adam as jax_init_adam
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs.base import ModelConfig as TorchConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.model import Model as TorchModel
from repro_torch.training.train_loop import make_train_step
from repro_torch.training.tree import tree_items

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the parity models are tiny: one intra-op thread a process, or pytest's
# parallel workers oversubscribe the cores and each small op waits its turn
torch.set_num_threads(1)

CPU = torch.device("cpu")


def both(a: np.ndarray, dtype: str = "float32"):
    """The same numpy array as a JAX array and a CPU torch tensor."""
    a = np.asarray(a)
    if dtype == "bfloat16":
        return (jnp.asarray(a.astype(np.float32), jnp.bfloat16),
                torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def port_config(cfg):
    """The port's ModelConfig with the reference config's fields."""
    import dataclasses
    return TorchConfig(**dataclasses.asdict(cfg))


def model_pair(cfg, *, seed: int = 0, moe_dispatch: str = "onehot"):
    """(jax_model, jax_params, torch_model, torch_params): one set of
    weights from the reference's init, converted for the port."""
    jm = JaxModel(cfg, moe_dispatch=moe_dispatch)
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = port_config(cfg)
    tm = TorchModel(tcfg, moe_dispatch=moe_dispatch, device="cpu")
    tp = params_from_jax(jax.device_get(jp), tcfg, CPU)
    return jm, jp, tm, tp


def assert_step_matches(cfg, batch, tcfg_kw, *, seed=0):
    """One reference step from its init, then the port and the reference
    each take a second step from the same params and moments (the port's
    converted).  loss, aux and grad norm 1e-5 relative, lr 5e-7; the
    moments hold the gradients: mu rtol 1e-4 atol 1e-8, nu rtol 1e-4 atol
    1e-12; every parameter leaf 1e-6 relative plus 0.05 x lr (AdamW's
    step divides by sqrt(v) + eps, which magnifies the last bits of a
    gradient near eps up to lr)."""
    jm = JaxModel(cfg, remat=True)
    jp = jm.init(jax.random.PRNGKey(seed))
    step = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**tcfg_kw)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp, jo, _ = step(jp, jax_init_adam(jp), jb)
    tcfg = port_config(cfg)
    tm = TorchModel(tcfg, remat=True, device="cpu")
    tp = params_from_jax(jax.device_get(jp), tcfg, CPU)
    to = opt_state_from_jax(jax.device_get(jo), tcfg, CPU)
    jp, jo, jmet = step(jp, jo, jb)
    tp, to, tmet = make_train_step(tm, TrainConfig(**tcfg_kw))(
        tp, to, {k: torch.from_numpy(np.asarray(v)) for k, v in
                 batch.items()})
    for k in ("loss", "aux_loss", "grad_norm", "total_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=5e-7)
    np.testing.assert_array_equal(to_np(tmet["expert_counts"]),
                                  np.asarray(jmet["expert_counts"]))
    assert int(to.step) == int(jo.step) == 2
    lr = float(jmet["lr"])
    ref_p = params_from_jax(jax.device_get(jp), tcfg, CPU)
    ref_o = opt_state_from_jax(jax.device_get(jo), tcfg, CPU)
    for tree, ref, rtol, atol in ((to.mu, ref_o.mu, 1e-4, 1e-8),
                                  (to.nu, ref_o.nu, 1e-4, 1e-12),
                                  (tp, ref_p, 1e-6, 0.05 * lr)):
        for (path, a), (rpath, b) in zip(tree_items(tree), tree_items(ref)):
            assert path == rpath and a.dtype == b.dtype
            np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol,
                                       atol=atol, err_msg=path)
