"""The device's trace over a traced part of the window (``--trace 1``).

``torch.profiler`` records device operations (kernels, copies, sets)
and the host's operations; :func:`reduce` turns them into what the
result line carries: ``busy_s``, the length of the UNION of the device
operations' intervals (operations on several streams that overlap count
once, where a plain sum would count them twice), ``window_s``, the host
clock's length of the traced part, the device operations that took most
time, and the idle gaps between device operations named by what the
host was doing then: the innermost of the program's own spans
(``repro_torch.obs``) that covers the gap's middle.
"""
from __future__ import annotations

import time
from collections import defaultdict

def union_seconds(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps
    counted once (same unit as the intervals)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The parts of ``[start, end]`` that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def innermost(spans, t: float) -> str:
    """Name of the deepest span covering ``t`` (perf_counter seconds on
    the spans' own clock), or ``"outside the program's spans"``."""
    best, depth = None, -1
    for name, s, e, d in spans:
        if s <= t <= e and d > depth:
            best, depth = name, d
    return best or "outside the program's spans"


class DeviceTrace:
    """A profiler over part of the window: :meth:`start`, the work,
    :meth:`stop`, then :meth:`reduce`."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self.prof = None
        self.t0 = self.t1 = None
        self.mark_perf = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        # a marker ties the profiler's clock to perf_counter
        self.mark_perf = time.perf_counter()
        with record_function("portbench.clock_mark"):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, spans=(), epoch: float = 0.0, top: int = 10) -> dict:
        """``busy_s``, ``window_s``, ``breakdown``.  ``spans`` are the
        program's finished spans (``obs`` records: name, t_start, t_end
        relative to ``epoch``, depth) used to name idle gaps."""
        events = self.prof.events()
        mark = next((e for e in events if e.name == "portbench.clock_mark"),
                    None)
        dev, by_name = [], defaultdict(float)
        for e in events:
            if getattr(e, "is_user_annotation", False):
                continue
            if str(e.device_type).split(".")[-1] != "CUDA":
                continue
            s, t = e.time_range.start, e.time_range.end
            dev.append((s, t))
            by_name[e.name] += (t - s) / 1e6
        window_s = self.t1 - self.t0
        out = {"window_s": window_s, "device_ops": len(dev)}
        if not dev or mark is None:
            out["busy_s"] = 0.0
            out["breakdown"] = {"device_ops": [], "idle_gaps": []}
            return out
        # profiler microseconds -> perf_counter seconds
        off = self.mark_perf - mark.time_range.start / 1e6
        lo = (self.t0 - off) * 1e6
        hi = (self.t1 - off) * 1e6
        inside = [(max(s, lo), min(t, hi)) for s, t in dev if t > lo and s < hi]
        out["busy_s"] = union_seconds(inside) / 1e6
        named = [(s.name, s.t_start + epoch, s.t_end + epoch, s.depth)
                 for s in spans if s.t_end + epoch >= self.t0
                 and s.t_start + epoch <= self.t1]
        idle = defaultdict(lambda: [0.0, 0])
        for a, b in gaps(inside, lo, hi):
            label = innermost(named, off + (a + b) / 2e6)
            idle[label][0] += (b - a) / 1e6
            idle[label][1] += 1
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([f"{k} ({n} gaps)", s]
                                 for k, (s, n) in idle.items()),
                                key=lambda kv: -kv[1])[:top]}
        return out
