"""Fixture: generator hazards (R5xx)."""
import torch

from repro_torch.core.graphs import RoundGraphs


def draws(x):
    a = torch.rand(3)
    x.normal_()
    g = torch.Generator()
    return a + x


def seeds(n, seed):
    out = []
    for _ in range(n):
        g = torch.Generator().manual_seed(seed)
        out.append(torch.rand(2, generator=g))
    return out


def capture(stage, generator):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stage(generator)
    return graph


def rounds(x, generator):
    graphs = RoundGraphs(x.device, capture=True)

    def stage(prev):
        return torch.rand(2, generator=generator)
    graphs.run(("k",), [stage])
