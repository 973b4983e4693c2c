"""Port's MoE layer vs the reference: routing, gmm dispatch, shared expert.

fp32 on the CPU; 2e-4 as in the reference's own gmm-vs-onehot parity test
(tests/test_ragged_gmm.py::test_moe_forward_gmm_parity_across_topk): the
sum over routed experts runs in another order in each framework."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, both, port_config, to_np
from repro.configs.base import ModelConfig
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import _map, _tensor


def _cfg(K, shared=1):
    return ModelConfig("m", "moe", 2, 64, 4, 2, 128, 256, num_experts=8,
                       num_experts_per_tok=K, moe_d_ff=128,
                       num_shared_experts=shared, dtype="float32")


def _layer(cfg, seed):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = (np.random.default_rng(seed).standard_normal((2, 33, cfg.d_model))
         * 0.5).astype(np.float32)
    return p, _map(jax.device_get(p), lambda a: _tensor(a, CPU)), x


@pytest.mark.parametrize("K", [1, 2, 4])
def test_moe_forward_gmm_matches_reference(K):
    cfg = _cfg(K)
    jp, tp, x = _layer(cfg, K)
    jx, tx = both(x)
    y_ref, _ = jmoe.moe_forward(jp, cfg, jx, dispatch="gmm")
    y = tmoe.moe_forward(tp, port_config(cfg), tx, dispatch="gmm")
    np.testing.assert_allclose(to_np(y), to_np(y_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_moe_gmm_matches_onehot(K):
    cfg = port_config(_cfg(K))
    _, tp, x = _layer(_cfg(K), K + 10)
    tx = torch.from_numpy(x)
    y_gmm = tmoe.moe_forward(tp, cfg, tx, dispatch="gmm")
    y_one = tmoe.moe_forward(tp, cfg, tx, dispatch="onehot")
    np.testing.assert_allclose(to_np(y_gmm), to_np(y_one), rtol=2e-4, atol=2e-4)


def test_router_breaks_ties_toward_lower_index():
    """All-equal router logits: lax.top_k picks experts 0..K-1 in order;
    the port must pick the same ones."""
    cfg = _cfg(4, shared=0)
    jp, tp, x = _layer(cfg, 0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = both(x.reshape(-1, cfg.d_model))
    jw, ji, _ = jmoe.router_topk(jp, cfg, jx)
    tw, ti, _ = tmoe.router_topk(tp, port_config(cfg), tx)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], np.arange(4))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


def test_unknown_dispatch_raises():
    cfg = _cfg(2)
    _, tp, x = _layer(cfg, 0)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tmoe.moe_forward(tp, port_config(cfg), torch.from_numpy(x),
                         dispatch="ep")
