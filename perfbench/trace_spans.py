"""The program's own spans in a ``torch.profiler`` Chrome trace of the
measured window: the ``user_annotation`` events other than the harness's
call span (``ddp_tpu_torch.diagnostics.profiling.span`` opens them), by
name, with how often each ran, its time, its self time, and the host syncs
and device operations made inside it.  A program without spans gives an
empty result.

    from perfbench.trace_spans import program_spans
    spans = program_spans(json.load(open(path))["traceEvents"])
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench.trace_reduce import CALL_SPAN, DEVICE_CATS, _clip, _union

# the CUDA runtime calls that make the host wait for the card (a blocking
# copy from pageable memory, ``.item()`` and ``torch.cuda.synchronize``
# reach the card through these)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def program_spans(events) -> dict:
    """``events`` (a trace's ``traceEvents``) as {name: {count, total_s,
    self_s, syncs, device_ops}} over the program spans that run on the
    harness's calling thread and start inside one of its call spans.
    ``self_s`` is a span's time less the union of the program spans nested
    directly inside it; ``syncs`` counts the runtime calls of ``SYNCS`` that
    start inside it, and ``device_ops`` the device events (kernel, memcpy,
    memset) whose launch does, its children's included.  Times in the trace
    are microseconds."""
    calls, marks, syncs, launch, device = [], [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name, tid = ev.get("cat") or "", ev["name"], ev.get("tid")
        ts = float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            (calls if name == CALL_SPAN else marks).append((ts, end, name, tid))
        elif cat.startswith("cuda_"):
            if corr is not None:
                launch[corr] = (ts, tid)
            if name in SYNCS:
                syncs.append((ts, tid))
        elif cat in DEVICE_CATS and corr is not None:
            device.append(corr)
    if not calls:
        return {}
    calls.sort()
    tid = calls[0][3]
    starts = [s for s, *_ in calls]

    def in_call(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= calls[i][1]

    sync_ts = sorted(t for t, th in syncs if th == tid)
    op_ts = sorted(launch[c][0] for c in device if c in launch and launch[c][1] == tid)

    def inside(ts, s, e):
        return bisect.bisect_right(ts, e) - bisect.bisect_left(ts, s)

    # spans nest on one thread: opened in order, the innermost still open
    # when a span starts is its parent
    spans, stack, children = [], [], defaultdict(list)
    for s, neg_e, name in sorted((s, -e, name) for s, e, name, th in marks if th == tid and in_call(s)):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            children[stack[-1]].append((s, -neg_e))
        stack.append(len(spans))
        spans.append((s, -neg_e, name))
    out = {}
    for i, (s, e, name) in enumerate(spans):
        nested = sum(b - a for a, b in _union(_clip(children[i], s, e)))
        rec = out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0, syncs=0, device_ops=0))
        rec["count"] += 1
        rec["total_s"] += 1e-6 * (e - s)
        rec["self_s"] += 1e-6 * (e - s - nested)
        rec["syncs"] += inside(sync_ts, s, e)
        rec["device_ops"] += inside(op_ts, s, e)
    return out
