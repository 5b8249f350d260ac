"""The traced run's reading of the device: torch.profiler around whole
batches inside the window, reduced to what the per-layer readers in
metrics/ take.

Device operations are the profiler's CUDA events (kernels, copies,
memsets). The traced window is the host span the harness opens around its
batches (it ends after a synchronize); device operations are clipped to it.
busy is the union of their intervals, so it is right for any number of
streams. Each idle gap is named by the innermost host operation running at
its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.autograd import DeviceType

SPAN = "benchmark.window"
LOOK_BACK = 64  # host ops searched back from a gap's middle for the one running


def summarize(prof, steps: int) -> dict:
    events = list(prof.events())
    spans = [e for e in events if e.name == SPAN and e.device_type == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.name == SPAN:
            continue
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1:
            continue
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, max(s, w0), min(t, w1)))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, s, t))
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s, t in dev:
        by_name[name][0] += (t - s) / 1e6
        by_name[name][1] += 1
    merged = []
    for _, s, t in sorted(dev, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    gaps, at = [], w0
    for s, t in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    idle = defaultdict(float)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    for s, t in gaps:
        mid = 0.5 * (s + t)
        # host ops nest, so the innermost one running at mid is the latest
        # started one that has not ended; a few steps back find it
        j = bisect.bisect_right(starts, mid) - 1
        name = "(no host op)"
        for k in range(j, max(-1, j - LOOK_BACK), -1):
            if host[k][2] >= mid:
                name = host[k][0]
                break
        idle[name] += (t - s) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy,
        "steps": steps,
        "kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
        "device_ops": sum(v[1] for v in by_name.values()),
        "idle": dict(idle),
    }


def breakdown(summary: dict) -> dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span():
    return torch.profiler.record_function(SPAN)
