"""Reduce a torch.profiler trace of a few steps to what the per-layer
metrics and the result's ``breakdown`` read.

The profiler's chrome trace is written to a temporary file, read back and
deleted: kineto's event categories ("kernel", "gpu_memcpy", "gpu_memset"
on the device; "cpu_op", "user_annotation" on the host) are the stable
part of its format.  Device time is the union of the device operations'
intervals, so two that overlap count once.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Slice:
    """A profiled slice of steps: its wall time (host clock, from a
    synchronised device to a synchronised device), the device operations
    (name, start µs, duration µs) and the host operations."""

    window_s: float
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in busy_intervals(self.device_ops)) / 1e6

    def time_of(self, fragment: str) -> tuple[int, float]:
        """(launches, summed µs) of the device operations whose name holds
        ``fragment``."""
        hits = [d for n, _, d in self.device_ops if fragment in n]
        return len(hits), sum(hits)


def busy_intervals(ops) -> list[tuple[float, float]]:
    """The union of the [start, start + duration) intervals of ``ops``."""
    out: list[list[float]] = []
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        end = start + dur
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def record(profile_fn, warm, run, with_host: bool) -> Slice:
    """Profile ``run()`` under ``profile_fn``
    (torch.profiler.profile) with CUDA activity, and the host ops too when
    ``with_host``.  ``warm()`` runs first under the profiler's warm-up,
    which records nothing, so that its start-up costs fall outside the
    slice; the slice runs from a synchronised card to a synchronised card."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host else [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile_fn(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                        on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = (str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            device.append(op)
        elif e.get("cat") in HOST_CATS:
            host.append(op)
    return Slice(window_s=window_s, device_ops=device, host_ops=host)


def top_device_ops(sl: Slice, n: int = 10) -> list[list]:
    """The ``n`` device operations with the most time, summed by name, in
    seconds."""
    total: dict[str, float] = {}
    for name, _, dur in sl.device_ops:
        total[name] = total.get(name, 0.0) + dur / 1e6
    return [[k[:120], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(sl: Slice, n: int = 10) -> list[list]:
    """The ``n`` longest gaps between device operations, each named by the
    innermost host operation running at the gap's middle, in seconds."""
    spans = busy_intervals(sl.device_ops)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) / 2
        inside = [(d, name) for name, s, d in sl.host_ops
                  if s <= mid < s + d and not name.startswith("ProfilerStep")]
        label = min(inside)[1] if inside else "no host op (Python between ops)"
        out.append([f"host in {label}"[:120], (b - a) / 1e6])
    return out
