"""The reduction of the program's spans (``trace_spans.py``) on a hand-made
Chrome trace, and ``reduce_trace``'s numbers with and without those spans.

    python -m pytest perfbench/test_perfbench_spans.py -q
"""

from __future__ import annotations

import json

import pytest

from perfbench.trace_reduce import CALL_SPAN, reduce_trace
from perfbench.trace_spans import program_spans

US = 1e-6


def ev(cat, name, ts, dur, tid=1, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1, args=args)


def trace(with_spans: bool) -> list:
    """Two harness calls on thread 1, [100, 200] and [300, 400] µs.  The
    first: the root [110, 190] holding the pack [120, 150]; a sync in the
    pack (125) and one in the root (185); a copy launched in the pack (130,
    device [131, 133]) and a kernel in the root (160, device [170, 188]);
    the harness's own sync after the root (195).  The second: the root
    [310, 380] holding the pack [320, 330], a kernel launched in the root
    (340, device [345, 375]).  Beside them, program spans that the
    reduction leaves out: one after the last call and one on another
    thread."""
    evs = [
        ev("user_annotation", CALL_SPAN, 100, 100), ev("user_annotation", CALL_SPAN, 300, 100),
        ev("cuda_runtime", "cudaStreamSynchronize", 125, 2), ev("cuda_runtime", "cudaStreamSynchronize", 185, 3),
        ev("cuda_runtime", "cudaMemcpyAsync", 130, 1, corr=8), ev("cuda_runtime", "cudaLaunchKernel", 160, 2, corr=7),
        ev("cuda_runtime", "cudaDeviceSynchronize", 195, 4), ev("cuda_runtime", "cudaLaunchKernel", 340, 2, corr=9),
        ev("gpu_memcpy", "Memcpy HtoD", 131, 2, tid=7, corr=8), ev("kernel", "solve", 170, 18, tid=7, corr=7),
        ev("kernel", "solve", 345, 30, tid=7, corr=9), ev("cpu_op", "aten::cat", 140, 5),
    ]  # fmt: skip
    if with_spans:
        evs += [
            ev("user_annotation", "solve_flat", 110, 80), ev("user_annotation", "solve_flat.pack", 120, 30),
            ev("user_annotation", "solve_flat", 310, 70), ev("user_annotation", "solve_flat.pack", 320, 10),
            ev("user_annotation", "solve_flat", 500, 20), ev("user_annotation", "solve_flat", 150, 20, tid=2),
        ]  # fmt: skip
    return evs


def same(got, want):
    """Lists of (name or seconds, seconds) pairs equal, seconds to rounding."""
    assert len(got) == len(want)
    for (a, x), (b, y) in zip(got, want):
        assert a == pytest.approx(b) and x == pytest.approx(y)


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    return str(path)


def test_program_spans_by_name():
    spans = program_spans(trace(with_spans=True))
    assert set(spans) == {"solve_flat", "solve_flat.pack"}
    root, pack = spans["solve_flat"], spans["solve_flat.pack"]
    assert root["count"] == pack["count"] == 2
    assert root["total_s"] == pytest.approx((80 + 70) * US)
    assert root["self_s"] == pytest.approx((80 - 30 + 70 - 10) * US)
    assert (root["syncs"], root["device_ops"]) == (2, 3)
    assert pack["total_s"] == pytest.approx(pack["self_s"]) == pytest.approx(40 * US)
    assert (pack["syncs"], pack["device_ops"]) == (1, 1)


def test_a_trace_without_program_spans_has_none():
    assert program_spans(trace(with_spans=False)) == {}
    assert program_spans([ev("user_annotation", "solve_flat", 0, 5)]) == {}


def test_program_spans_leave_the_window_numbers_alone(tmp_path):
    """The numbers ``reduce_trace`` gives for the trace without program
    spans, by hand; with them the same, but the idle gaps that fall inside a
    root go to it and no longer to the harness's call span."""
    plain = reduce_trace(write(tmp_path, trace(with_spans=False)))
    assert plain["window_s"] == pytest.approx(300 * US) and plain["busy_s"] == pytest.approx(50 * US)
    same(plain["calls"], [(100 * US, 20 * US), (100 * US, 30 * US)])
    same(plain["device_ops"], [("solve", 48 * US), ("Memcpy HtoD", 2 * US)])
    python = f"{CALL_SPAN}: Python between operations"
    same(plain["idle_gaps"], [("between calls, no host operation", 157 * US), (python, (31 + 37 + 25) * US)])
    spanned = reduce_trace(write(tmp_path, trace(with_spans=True)))
    for key in ("window_s", "busy_s", "calls", "device_ops"):
        assert spanned[key] == plain[key], key
    same(spanned["idle_gaps"],
         [("between calls, no host operation", 157 * US), ("solve_flat", (31 + 37) * US), (python, 25 * US)])
