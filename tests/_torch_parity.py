"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX reference
and the port.  fp32 parity runs with TF32 off: it does not apply on the CPU,
and is switched off so the same comparisons keep full fp32 on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import Model as JaxModel
from repro_torch.configs.base import ModelConfig as TorchConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model as TorchModel

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
