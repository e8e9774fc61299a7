"""Reduce a torch.profiler window to what the per-layer metrics read.

Device activity (kernels, copies, sets; not the annotations the profiler
mirrors on the device's timeline) becomes sorted (start, end, name)
intervals in seconds; host spans (``record_function`` ranges: the
program's ``run_sweep/*`` stages and the benchmark's own ``portbench/*``
spans) likewise. The window is the benchmark's ``portbench/window`` span.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

Interval = Tuple[float, float, str]


class Trace(NamedTuple):
    window: Tuple[float, float]
    device: List[Interval]        # device activity, sorted by start
    host: List[Interval]          # host spans, sorted by start

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_seconds(self, substring: str) -> float:
        """Device seconds of the kernels whose name holds ``substring``."""
        return sum(b - a for a, b, n in self.device if substring in n)


def _events(prof):
    """(name, is_device, is_annotation, start_s, end_s) of every event."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               bool(e.is_user_annotation()), e.start_ns() * 1e-9,
               e.end_ns() * 1e-9)


def reduce(prof, host_prefixes=("run_sweep/", "portbench/")) -> Trace:
    device, host = [], []
    window = None
    for name, on_device, annotation, a, b in _events(prof):
        if on_device:
            if not annotation:
                device.append((a, b, name))
        elif name == "portbench/window":
            window = (a, b)
        elif name.startswith(host_prefixes):
            host.append((a, b, name))
    if window is None:
        raise RuntimeError("the trace holds no portbench/window span")
    device = sorted(x for x in device if x[1] > window[0] and x[0] < window[1])
    return Trace(window, device, sorted(host))


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of device activity inside the window, merged."""
    lo, hi = trace.window
    out: List[List[float]] = []
    for a, b, _ in trace.device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def top_device_ops(trace: Trace, n: int = 10) -> List[list]:
    """The ``n`` device operations by name that took the most seconds."""
    tot: Dict[str, float] = defaultdict(float)
    for a, b, name in trace.device:
        tot[name[:120]] += b - a
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host_span(trace: Trace, n: int = 10) -> List[list]:
    """Device-idle seconds inside the window, summed by the innermost host
    span open at each idle gap's midpoint (``host`` where none is): the
    ``n`` largest."""
    lo, hi = trace.window
    gaps = []
    t = lo
    for a, b in busy_intervals(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    tot: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in trace.host]
    import bisect
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "host"
        # Innermost: the latest-starting span that still covers the point.
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(i - 64, -1), -1):
            s, e, name = trace.host[j]
            if s <= mid <= e and (best is None or s > best[0]):
                best = (s, name)
        if best is not None:
            label = best[1]
        tot[label] += b - a
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def roofline(ctx, count: str):
    """A kernel's least time over the traced sweeps (``counts/<count>``)
    over its device seconds in the trace, %; None without a launch."""
    from .cells import load_module
    c = load_module("counts", count)
    busy = ctx.trace.kernel_seconds(c.KERNEL)
    if busy <= 0 or not ctx.traced:
        return None
    return 100.0 * sum(c.least_seconds(ctx, s) for s in ctx.traced) / busy
