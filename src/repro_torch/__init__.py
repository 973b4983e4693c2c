"""PyTorch/CUDA port of the MoESD serving stack (the JAX package ``repro`` is
the reference it is tested against).

The layout mirrors ``repro``: ``configs``, ``data``, ``models``, ``kernels``,
``core``, ``serving``, ``launch``.  The port imports neither JAX nor
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
