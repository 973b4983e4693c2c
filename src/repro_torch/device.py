"""Device resolution shared by every entry point of the port, and the
sync debug mode around the engine's explicit host crossings."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  There is no silent CPU fallback: with no card and no
    explicit ``device="cpu"`` this raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


@contextmanager
def sync_debug_mode(mode: Union[str, int]) -> Iterator[None]:
    """Run the body under ``torch.cuda.set_sync_debug_mode(mode)`` and
    restore the mode it found; without a card there is no mode to set."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def host_crossing():
    """An explicit host<->device crossing of the engine: a round's one
    readback, an admission, a report.  It lifts the sync debug mode that
    ``SDEngine.sync_guard`` and ``analysis.runtime.transfer_guard`` set, as
    ``np.asarray(device_array)`` is free under the reference's transfer
    guard.  A context manager, and a decorator."""
    return sync_debug_mode("default")
