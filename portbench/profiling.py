"""The profiler's reduction (after chip_smoke.py's ``profile_run``),
read from the trace torch.profiler exports (the Chrome trace format):
device busy time as the union of kernel, copy and set intervals, device
time by kernel name and by launching op, and the idle gaps labelled by
what the host was doing during each.

A kernel belongs to an op when the runtime call that launched it (the
host event with the kernel's ``correlation`` id) ran inside that op on
the same thread; a graph's kernels belong to the graph's launch. With
the port's spans turned on as profiler ranges
(``obs.trace.enable(jax_annotations=True)``), a gap's label is the
innermost host range open at its middle: a span such as
``fleet.dispatch`` or an op such as ``aten::linalg_eigh``.
"""

from __future__ import annotations

import heapq
import json
import os
import time

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH = ("cuda_runtime", "cuda_driver")


def run(torch, fn):
    """``fn()`` under torch.profiler over the CPU and the card; returns
    (the host wall of fn in seconds, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def trace_events(prof, path):
    """The profiler's trace, written to ``path`` and read back."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def merged(intervals):
    """The union of ``intervals`` [(start, end)] as disjoint [start, end]
    pairs in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def op_device_s(events, names):
    """Seconds of device time of the kernels launched inside the host
    ops ``names`` (a kernel inside nested matches counts once)."""
    ops = {}
    for e in events:
        if e.get("cat") in HOST and e.get("name") in names:
            ops.setdefault(e.get("tid"), []).append(_span(e))
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), _span(e)[0])
    total = 0.0
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        if any(s <= ts <= t for s, t in ops.get(tid, ())):
            total += float(e.get("dur", 0.0))
    return total * 1e-6


def innermost(ranges, points):
    """For each of ``points`` the name of the innermost range of
    ``ranges`` [(name, start, end)] open at it (the latest start, then
    the earliest end), or "host (no range open)": one sweep in time
    order, the open ranges on a heap."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ranges = sorted(ranges, key=lambda r: r[1])
    out = [None] * len(points)
    heap, k = [], 0
    for j in order:
        p = points[j]
        while k < len(ranges) and ranges[k][1] <= p:
            name, s, t = ranges[k]
            heapq.heappush(heap, (-s, t, k, name))
            k += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        # a range that ended before p under a later-starting one stays
        # on the heap until it surfaces; it is dropped then
        out[j] = heap[0][3] if heap else "host (no range open)"
    return out


def reduce(events, top=10):
    """{"busy_s", "kernel_s" {name: s}, "device_ops" [[name, s]],
    "idle_gaps" [[label, s]], "events"}, or None when the trace holds no
    device time."""
    kernels = [(e["name"],) + _span(e) for e in events
               if e.get("cat") in DEVICE and e.get("dur", 0) > 0]
    if not kernels:
        return None
    host = [(e["name"],) + _span(e) for e in events
            if e.get("cat") in HOST]
    busy = merged((s, t) for _, s, t in kernels)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    by_name = {}
    for name, s, t in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    lo = min(s for _, s, _ in kernels + host)
    hi = max(t for _, _, t in kernels + host)
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    labels = {}
    for (s, t), label in zip(gaps, innermost(
            host, [0.5 * (s + t) for s, t in gaps])):
        labels[label] = labels.get(label, 0.0) + (t - s) * 1e-6
    return {
        "busy_s": busy_s,
        "kernel_s": by_name,
        "device_ops": [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            labels.items(), key=lambda kv: -kv[1])[:top]],
        "events": events,
    }
