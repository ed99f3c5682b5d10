"""what a torch.profiler trace of the program says: device time by the
program's `d2t::` ranges and ops, the device's busy time, its top
operations and its longest idle gaps, named by the range the host was in.

Stage and op times are torch.profiler's `device_time_total` of the host
range (the kernels launched inside it). Busy time is the union of the
device's kernel, copy and set intervals in the exported Chrome trace.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]):
    """merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Profile:
    """one profiled stretch of `calls` calls that took `wall_s` seconds."""

    def __init__(self, prof, wall_s: float, calls: int, items: int) -> None:
        import torch

        self.wall_s, self.calls, self.items = wall_s, calls, items
        cuda = torch.autograd.DeviceType.CUDA
        self.ranges: Dict[str, Tuple[float, int]] = {}  # host range -> (device us, count)
        for e in prof.key_averages():
            if e.device_type != cuda:
                self.ranges[e.key] = (float(e.device_time_total), int(e.count))
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        device, host = [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            if ev.get("cat") in DEVICE_CATS:
                device.append((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev.get("name", "")))
            elif ev.get("cat") == "user_annotation" and ev.get("name", "").startswith("d2t::"):
                host.append((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["name"]))
        self.device_events = device
        self.host_ranges = host
        merged = _union([(s, e) for s, e, _ in device])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self._merged = merged

    def device_us(self, name: str) -> float:
        """device time of the kernels launched inside host range or op `name`."""
        return self.ranges.get(name, (0.0, 0))[0]

    def count(self, name: str) -> int:
        return self.ranges.get(name, (0.0, 0))[1]

    def top_ops(self, n: int = 10):
        """[name, seconds] of the device operations that took most time."""
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device_events:
            by_name[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def host_range_at(self, t: float) -> str:
        """the innermost `d2t::` range the host was in at time t (us)."""
        inside = [(s, name) for s, e, name in self.host_ranges if s <= t < e]
        return max(inside)[1] if inside else "host outside the d2t ranges"

    def idle_gaps(self, n: int = 10):
        """[name, seconds] of the longest idle gaps between device intervals,
        each named by the host's range at the gap's start."""
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self._merged, self._merged[1:])]
        gaps.sort(reverse=True)
        return [[self.host_range_at(t), g / 1e6] for g, t in gaps[:n]]


class Context:
    """what a per-layer reader reads: the cell, its runner and state, the
    unprofiled stretch (items done and seconds), the profiled one, and the
    least time of each hand-written kernel over the profiled calls (ms, the
    runner's `kernel_bounds_ms`)."""

    def __init__(self, cell, runner, state, items_unprofiled: int, seconds_unprofiled: float,
                 profile: Profile, bounds_ms: Dict[str, float]) -> None:
        self.cell, self.runner, self.state = cell, runner, state
        self.items_unprofiled, self.seconds_unprofiled = items_unprofiled, seconds_unprofiled
        self.profile, self.bounds_ms = profile, bounds_ms


def stage_ms(ctx: Context, name: str):
    """device ms a profiled item under host range `name`, or None where the
    range never ran."""
    if ctx.profile.count(name) == 0:
        return None
    return ctx.profile.device_us(name) / 1e3 / ctx.profile.items


def roofline(ctx: Context, kernel: str, op: str):
    """the least time of `kernel` over the profiled calls (the runner's
    bound) over the device time of op `op`, in %; None where it never ran."""
    t_ms = ctx.profile.device_us(op) / 1e3
    if ctx.profile.count(op) == 0 or t_ms <= 0:
        return None
    bound = ctx.bounds_ms.get(kernel)
    return None if bound is None else 100.0 * bound / t_ms
