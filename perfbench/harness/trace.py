"""Device activity from a ``torch.profiler`` trace, and its reductions.

``Trace`` holds every device operation (kernel, copy, set) and every host
operation of a profiled stretch as (start, end, name) in seconds.  The
reductions are plain arithmetic on those intervals, so the tests check them
on hand-made ones.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float, str]


def union_seconds(ops: Sequence[Interval]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, None
    for s, e, _ in sorted(ops):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(ops: Sequence[Interval], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no operation ran, longest first."""
    gaps, end = [], lo
    for s, e, _ in sorted(ops):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    return sorted(gaps, key=lambda g: g[0] - g[1])


def seconds_by_name(ops: Sequence[Interval]) -> Dict[str, float]:
    by: Dict[str, float] = {}
    for s, e, name in ops:
        by[name] = by.get(name, 0.0) + (e - s)
    return by


def host_label(host: Sequence[Interval], starts: List[float], a: float,
               b: float) -> str:
    """What the host was doing through the gap [a, b]: the host operation
    that overlaps it most (``host`` sorted by start, ``starts`` its starts);
    ``"host: python"`` where none does."""
    best, best_t = "host: python", 0.0
    i = bisect.bisect_right(starts, b)
    for s, e, name in host[max(0, i - 4096): i]:
        t = min(e, b) - max(s, a)
        if t > best_t:
            best, best_t = name, t
    return best


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    lo: float = 0.0                   # the profiled stretch, trace clock
    hi: float = 0.0

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds([(max(s, self.lo), min(e, self.hi), n)
                              for s, e, n in self.device
                              if e > self.lo and s < self.hi])

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(seconds_by_name(self.device).items(),
                     key=lambda kv: -kv[1])[:n]
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        gaps = idle_gaps(self.device, self.lo, self.hi)[:n]
        return {"device_ops": [[name[:120], sec] for name, sec in top],
                "idle_gaps": [[host_label(host, starts, a, b)[:120], b - a]
                              for a, b in gaps]}


def record(prof, span: str = "perfbench.unit") -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile`` (CPU and CUDA
    activity).  The stretch is the host range named ``span``
    (``torch.profiler.record_function``), or the whole trace without one;
    that range labels no gap."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for ev in kineto.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            (dev if ev.device_type() == cuda else host).append(
                (s, e, ev.name()))
    else:
        for ev in prof.events():
            s = ev.time_range.start * 1e-6
            e = ev.time_range.end * 1e-6
            (dev if ev.device_type == cuda else host).append((s, e, ev.name))
    spans = [(s, e) for s, e, n in host if n == span]
    host = [h for h in host if h[2] != span]
    dev = [d for d in dev if d[2] != span]      # its annotation on the device
    allev = dev + host
    if spans:
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    else:
        lo = min((s for s, _, _ in allev), default=0.0)
        hi = max((e for _, e, _ in allev), default=0.0)
    return Trace(device=dev, host=host, lo=lo, hi=hi)
