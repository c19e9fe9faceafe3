"""Reduce a ``torch.profiler`` Chrome trace of the measured window to the
numbers the per-layer readers take: the window, the device's busy time, each
call's wall and device time, the device operations that took most time and
the longest idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

CALL_SPAN = "perfbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")  # and the CUDA API's calls, "cuda_*"
TOP = 10


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_trace(path) -> dict:
    """The trace at ``path`` (``export_chrome_trace``) as: ``window_s`` (first
    call span's start to the last one's end), ``busy_s`` (union of device
    activity inside it), ``calls`` (per call span: wall seconds and the union
    of the device work its launches made, in seconds), ``device_ops`` and
    ``idle_gaps`` (each at most 10 [name, seconds], largest first).  Times
    in the trace are microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, device, host, launch_ts = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat") or ""
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev["name"], (ev.get("args") or {}).get("correlation")))
        elif cat in HOST_CATS or cat.startswith("cuda_"):
            host.append((ts, ts + dur, ev["name"], ev.get("tid")))
            if cat.startswith("cuda_") and (corr := (ev.get("args") or {}).get("correlation")) is not None:
                launch_ts[corr] = ts
            if cat == "user_annotation" and ev["name"] == CALL_SPAN:
                spans.append((ts, ts + dur, ev.get("tid")))
    if not spans:
        return {}
    spans.sort()
    lo, hi = spans[0][0], spans[-1][1]
    busy = _union(_clip([(s, e) for s, e, _, _ in device], lo, hi))
    busy_us = sum(e - s for s, e in busy)

    # each call's device work: what was launched inside its span
    starts = [s for s, _, _ in spans]
    per_call = defaultdict(list)
    by_name = defaultdict(float)
    for s, e, name, corr in device:
        if e > lo and s < hi:
            by_name[name] += min(e, hi) - max(s, lo)
        t = launch_ts.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            per_call[i].append((s, e))
    calls = []
    for i, (s, e, _) in enumerate(spans):
        work = _union(per_call.get(i, ()))
        calls.append((1e-6 * (e - s), 1e-6 * sum(b - a for a, b in work)))

    # idle gaps inside the window, each put to the innermost host operation
    # of the calling thread that covers its middle
    tid = spans[0][2]
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    mine = sorted((s, -e, name) for s, e, name, t in host if t == tid)
    stack, j = [], 0
    idle = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while j < len(mine) and mine[j][0] <= mid:
            stack.append((mine[j][0], -mine[j][1], mine[j][2]))
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        # events nest on one thread: the top is the innermost one open at mid
        name = stack[-1][2] if stack else "between calls, no host operation"
        if name == CALL_SPAN:
            name = f"{CALL_SPAN}: Python between operations"
        idle[name] += b - a

    def top(d):
        return [[k, 1e-6 * v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(
        window_s=1e-6 * (hi - lo), busy_s=1e-6 * busy_us, calls=calls,
        device_ops=top(by_name), idle_gaps=top(idle),
    )  # fmt: skip
