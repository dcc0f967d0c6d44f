"""The measured window, and with ``--trace 1`` what the profiler saw in it.

``Window`` times the window on the host clock, ending after a synchronise.
Traced, it runs ``torch.profiler`` over the window (host ops and device
activity), marks the window with a ``record_function`` range, and reduces
the trace in memory once the window has closed (nothing is exported):

- ``busy_s``: the union of the device's operation intervals inside the
  window, ``window_s`` the window's length on the trace's clock;
- ``kernels``: device seconds and count by operation name;
- ``ranges``: device seconds of the operations launched under each
  ``record_function`` range the benchmark put around a program function;
- ``breakdown``: the ten device operations that took most time, and the
  ten host operations under which the device stood idle longest (every
  idle gap summed by the host operation running when it began).
"""
from __future__ import annotations

import bisect
import heapq
import time
from dataclasses import dataclass, field

import torch

WINDOW = "chipbench.window"


@dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: dict = field(default_factory=dict)      # name -> [seconds, count]
    ranges: dict = field(default_factory=dict)       # range name -> device seconds
    breakdown: dict = field(default_factory=dict)
    linked: float = 0.0                              # share of operations linked to a launch

    def kernel_s(self, fragments) -> tuple[float, int]:
        """Device seconds and launches of the operations whose name holds
        any of ``fragments``."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if any(f in name for f in fragments):
                s += sec
                n += count
        return s, n


class Window:
    """``with Window(device, traced) as w:`` ... ``w.seconds`` after."""

    def __init__(self, device, traced: bool = False, ranges=()):
        """``ranges``: names of the ``record_function`` ranges to read."""
        self.device, self.traced, self.ranges = device, traced, tuple(ranges)
        self.prof = self.mark = self.summary = None
        self.seconds = 0.0

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.mark = record_function(WINDOW)
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0
        if self.traced:
            self.mark.__exit__(*exc)
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = reduce(self.prof, self.ranges)
            self.prof = None
        return False


def _merge(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, range_names=()) -> Summary:
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device, host, launches, annotations = [], [], {}, []
    win = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            start, end = e.start_ns(), e.end_ns()
            if name == WINDOW:
                win = (start, end)
            elif name in range_names:
                annotations.append((start, end, name))
            else:
                # a device operation's linked id is that of the host op or
                # the launch call that queued it: either starts under the
                # range the launch was made in
                host.append((start, end, name))
                launches.setdefault(e.correlation_id(), []).append(start)
        elif not _annotation(e, range_names):
            device.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id()))
    if win is None:
        raise RuntimeError("the trace holds no window range")
    lo, hi = win
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    busy = _merge([[max(s, lo), min(e, hi)] for s, e, _, _ in inside])
    busy_ns = sum(e - s for s, e in busy)

    kernels = {}
    for s, e, name, _ in inside:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (min(e, hi) - max(s, lo)) / 1e9
        k[1] += 1

    ranges = {}
    by_name = {}
    for s, e, name in annotations:
        by_name.setdefault(name, []).append((s, e))
    for name, spans in by_name.items():
        spans = _merge([list(x) for x in spans])
        starts = [s for s, _ in spans]
        total = 0
        for s, e, _, corr in inside:
            for t in launches.get(corr, ()):
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= spans[i][1]:
                    total += min(e, hi) - max(s, lo)
                    break
        ranges[name] = total / 1e9
    linked = sum(1 for d in inside if d[3] in launches)
    if inside and linked < 0.5 * len(inside):
        ranges = {}                   # launches not linked: no range can be read

    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    breakdown = {"device_ops": [[n[:160], v[0]] for n, v in top],
                 "idle_gaps": _gaps(busy, lo, hi, host)}
    return Summary(busy_ns / 1e9, (hi - lo) / 1e9, kernels, ranges, breakdown,
                   linked / max(len(inside), 1))


def _annotation(e, range_names) -> bool:
    """A range's copy on the device's timeline (kineto's GPU user
    annotation): it spans the kernels launched under the range, so it is no
    operation of its own."""
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or e.name() == WINDOW or e.name() in range_names


def _gaps(busy, lo, hi, host):
    """The idle gaps inside the window, summed by the innermost host op
    running when each began (the one that started last of those not yet
    ended): one sweep over the gaps and the host ops in time order."""
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted((edges[i], edges[i + 1] - edges[i]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    host.sort()
    running, j, named = [], 0, {}
    for t, length in gaps:
        while j < len(host) and host[j][0] <= t:
            heapq.heappush(running, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while running and running[0][1] < t:        # ended before the gap began
            heapq.heappop(running)
        name = running[0][2] if running else "host outside any op"
        named[name] = named.get(name, 0) + length / 1e9
    return [[n[:160], s] for n, s in sorted(named.items(), key=lambda kv: -kv[1])[:10]]
