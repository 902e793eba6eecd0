"""The traced part of a run: torch.profiler over a bounded piece of work,
reduced to the device's busy time, its idle gaps by what the host was
doing, and each kernel's device time by name.

The raw events (`kineto_results.events()`) are read without building the
profiler's tree of function events, which costs about a millisecond of
host time per kernel (tens of seconds on a Newton loop's launches).
"""
from __future__ import annotations

import bisect
import time

TOP = 10
SCAN = 256        # CPU events looked back at to find the one over a gap


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(work, devices):
    """Run work() under torch.profiler; returns the reduction (seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for d in devices:
        torch.cuda.synchronize(d)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        for d in devices:
            torch.cuda.synchronize(d)
        window = time.perf_counter() - t0
    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    dev, cpu = {}, []
    for e in events:
        s, f = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.setdefault(e.device_index(), []).append((s, f, e.name()))
        elif e.device_type() == DeviceType.CPU and f > s:
            cpu.append((s, f, e.name()))
    kernels, ops = {}, {}
    busy, gaps = [], {}
    cpu.sort()
    starts = [c[0] for c in cpu]
    for iv in dev.values():
        for s, f, name in iv:
            kernels.setdefault(name, []).append((f - s) * 1e-9)
            ops[name] = ops.get(name, 0.0) + (f - s) * 1e-9
        merged = _union([(s, f) for s, f, _ in iv])
        busy.append(sum(f - s for s, f in merged) * 1e-9)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "no host op"
            for j in range(i, max(i - SCAN, -1), -1):
                if cpu[j][1] >= mid:
                    name = cpu[j][2]
                    break
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    n_dev = max(len(devices), 1)
    return {
        "window_s": window,
        "busy_s": sum(busy) / n_dev,
        "kernels": kernels,
        "device_ops": sorted(([k[:160], v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k[:160], v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "n_device_events": sum(len(v) for v in dev.values()),
        "reduce_s": time.perf_counter() - t,
    }


def kernel_times(prof: dict, *names) -> list:
    """Device seconds of every launch whose name holds one of `names`."""
    return [d for k, v in prof["kernels"].items()
            if any(n in k for n in names) for d in v]
