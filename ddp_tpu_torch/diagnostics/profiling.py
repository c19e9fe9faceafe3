"""Phase timing and convergence traces (≙ ddp_tpu/diagnostics/profiling.py).

≙ the reference runtime diagnostics: the RAII wall-clock chronometer that
appends to ``chrono.log``, the deduplicating log-file registry, and the
per-problem convergence trace files ``<name>_primal.dat``/``_dual.dat``.
Default paths lie in the temporary directory (``tempfile.gettempdir()``,
which follows ``TMPDIR``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

_LOG_FILES: dict[str, object] = {}  # dedup registry, ≙ log_file_t


def _tmp(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def log_file(path: str):
    """Deduplicated append-mode file handle registry."""
    if path not in _LOG_FILES:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _LOG_FILES[path] = open(path, "a")  # noqa: SIM115
    return _LOG_FILES[path]


def block_until_ready(tree) -> None:
    """Wait for the card to finish the work behind every CUDA tensor of
    ``tree`` (any pytree); a no-op when it holds none."""
    devices = {
        leaf.device
        for leaf in pytree.tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def chronometer(message: str, path: str | None = None, sync=None):
    """RAII-style wall-clock timer (≙ chronometer_t).  Pass a tensor (or a
    pytree of them) via ``sync`` to wait for the card to finish it before
    stopping the clock."""
    path = path or _tmp("chrono.log")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            block_until_ready(sync)
        dt = time.perf_counter() - t0
        f = log_file(path)
        f.write(f"done [{message}] in {dt * 1e3:.3f} ms\n")
        f.flush()


class ConvergenceTrace:
    """Append per-iteration primal/dual optimality to trace files
    (≙ <name>_primal.dat and _dual.dat)."""

    def __init__(self, name: str, directory: str | None = None):
        directory = directory or tempfile.gettempdir()
        self.primal = os.path.join(directory, f"{name}_primal.dat")
        self.dual = os.path.join(directory, f"{name}_dual.dat")

    def record(self, opt_constr, opt_obj) -> None:
        log_file(self.primal).write(f"{float(opt_constr)}\n")
        log_file(self.dual).write(f"{float(opt_obj)}\n")
        log_file(self.primal).flush()
        log_file(self.dual).flush()

    def record_history(self, history) -> None:
        """Append a whole ``SolveHistory`` (solve(..., history=True)): one
        primal/dual line per executed iteration, stopping at the first
        converged row (the fixed-count history repeats it afterwards)."""
        n = _executed_rows(history)
        for oc, oo in zip(_np(history.opt_constr)[:n], _np(history.opt_obj)[:n]):
            self.record(oc, oo)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _executed_rows(history) -> int:
    done = _np(history.done)
    return int(done.argmax()) + 1 if done.any() else done.shape[0]


def format_history(history) -> str:
    """Render a ``SolveHistory`` as the reference's per-iteration stdout
    block (μ/reg/w/n/step/‖eq‖ and the optimality measures); the same text
    as ``ddp_tpu``'s for the same values."""
    n = _executed_rows(history)
    h = {k: _np(getattr(history, k)) for k in history._fields}
    lines = [
        f"{'it':>4} {'mu':>10} {'reg':>10} {'w':>10} {'n':>10} {'step':>8}"
        f" {'opt_obj':>10} {'opt_lag':>10} {'|eq|':>10} upd"
    ]
    for i in range(n):
        upd = (
            "p+=mu*eq"
            if bool(h["upd_success"][i])
            else ("mu*=10" if bool(h["upd_failure"][i]) else "-")
        )
        lines.append(
            f"{i:>4} {float(h['mu'][i]):>10.3e}"
            f" {float(h['reg'][i]):>10.3e}"
            f" {float(h['w'][i]):>10.3e}"
            f" {float(h['n'][i]):>10.3e}"
            f" {float(h['step'][i]):>8.4f}"
            f" {float(h['opt_obj'][i]):>10.3e}"
            f" {float(h['opt_lag'][i]):>10.3e}"
            f" {float(h['opt_constr'][i]):>10.3e}"
            f" {upd}"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def device_profile(path: str | None = None):
    """``torch.profiler`` over CPU and (when a card is present) CUDA
    activities; on exit writes a Chrome trace, ``trace.json``, under
    ``path``.  Yields the profiler."""
    path = path or _tmp("torch-trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def timed_block_until_ready(fn, *args, n_rep: int = 5, **kw):
    """Steady-state wall time of a callable, its first (warm-up) call
    excluded; each call waits for the card.  Returns (result,
    seconds_per_call)."""
    res = fn(*args, **kw)
    block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        res = fn(*args, **kw)
        block_until_ready(res)
    return res, (time.perf_counter() - t0) / n_rep
