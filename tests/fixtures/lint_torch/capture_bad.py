"""Fixture: host work inside captured stages (T1xx; S403 for host data)."""
import torch

from repro_torch.core.graphs import RoundGraphs

TRACE = []


class Engine:
    def __init__(self, device):
        self.graphs = RoundGraphs(device, capture=True)
        self.rounds = 0

    def _stages(self, x):
        def stage(prev):
            y = torch.relu(x) + prev
            if y.sum() > 0:
                y = y * 2
            while y.max() > 1:
                y = y / 2
            n = int(y[0])
            v = y.item()
            print(f"{y}")
            assert y.min() >= 0
            for _ in range(y[0]):
                pass
            TRACE.append(n + v)
            self.rounds += 1
            return y + torch.tensor([1.0, 2.0])
        return [stage]

    def round(self, x):
        return self.graphs.run(("round", x.shape[0]), self._stages(x))


def timed(fn, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = torch.exp(x)
        host = y.cpu()
    return host
