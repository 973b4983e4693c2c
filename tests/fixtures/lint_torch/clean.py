"""Fixture: the sanctioned forms of every pattern the passes check."""
import ctypes
from pathlib import Path

import torch

from repro_torch.core.graphs import RoundGraphs
from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "launch_bad.cu"


def _lib():
    lib = build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.toy_launch.argtypes = [p, p, i, p]
    lib.toy_scale.argtypes = [p, i, f]
    lib.toy_bytes.argtypes = [i]
    lib.toy_bytes.restype = ctypes.c_longlong
    return lib


class Engine:
    def __init__(self, device, seed):
        self.graphs = RoundGraphs(device, capture=True)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._io = {}

    def round_key(self, x, gamma):
        return ("round", gamma, x.shape[0])

    def _stages(self, x, gamma, generator):
        def propose(prev):
            width = x.shape[0] * gamma
            drafts = torch.rand((width,), generator=generator, device=x.device)
            if drafts.shape[0] > 1:
                drafts = drafts[:1]
            return drafts

        def finalize(prev):
            out = torch.where(prev > 0.5, prev, torch.zeros_like(prev))
            return out.reshape(-1)
        return [propose, finalize]

    def round(self, x, gamma):
        key = self.round_key(x, gamma)
        io = self._io.get(key)
        if io is None:
            io = self._io[key] = torch.empty(1)
        stages = self._stages(x, gamma, self.generator)
        self.graphs.run(key, stages, generator=self.generator)
        return io


def launch(x, out, n, stream):
    lib = _lib()
    return lib.toy_launch(x.data_ptr(), out.data_ptr(), n, stream)


def fresh_copy(buf, new):
    buf.copy_(new)
    head = buf[0]
    return head.sum()
