"""Fixture: a round key that misses what its stages read (K2xx)."""
import torch

from repro_torch.core.graphs import RoundGraphs


class Engine:
    def __init__(self, device, temperature):
        self.graphs = RoundGraphs(device, capture=True)
        self.temperature = temperature
        self.scale = 2.0
        self._io = {}

    def round_key(self, x):
        return ("round", x.shape[0], self.temperature)

    def _stages(self, x, width, generator):
        def stage(prev):
            y = torch.zeros((x.shape[0], width))
            return y * self.scale + self.temperature
        return [stage]

    def round(self, x, width, generator):
        key = self.round_key(x)
        io = self._io.get(key)
        if io is None:
            io = self._io[key[1:]] = torch.empty(1)
        stages = self._stages(x, width, generator)
        return self.graphs.run(key, stages, generator=generator), io
