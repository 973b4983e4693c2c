"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version (``gmm``, ``decode_attention``, ``flash_attention``)."""
from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad.  No kernel has
    a backward, and each writes a fresh tensor through ``ctypes``, so a
    launch under autograd would drop its inputs' gradients silently; every
    route refuses alike, the plain CPU one included."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernels have no backward; an input requires "
            "grad.  The reference refuses as well (jax.grad through "
            "Model(moe_dispatch='gmm') raises NotImplementedError, through "
            "Model(use_flash=True) AssertionError): train with "
            "moe_dispatch='onehot' and without use_flash, as "
            "launch/train.py does.")
