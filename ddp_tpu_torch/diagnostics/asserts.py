"""Expression-decomposing assertion engine (≙ ddp_tpu/diagnostics/asserts.py).

≙ the reference's assertion front-end (detail/assertions.hpp:204-292):
`DDP_ASSERT_MSG_ALL_OF` / `_ANY_OF` decompose each condition into
lhs-op-rhs with captured values and report every failing conjunct, with
fatal (assert) and non-fatal (expect) flavors.

Python has no macros, so this uses expression templates instead of
stringification: ``val(x)`` wraps a value in a comparison-capturing proxy,
and ``ddp_assert(val(mu) > 0, val(len(xs)) == T + 1, msg=...)`` reports, for
every failing condition, the operator and both operand values — the
information the reference gets from `#a op #b` decomposition.  A failure
raises ``AssertionError``; ``ddp_expect`` is the non-fatal flavor (prints,
returns False).  A tensor-valued condition holds when all its entries do.

Host-side only, like the reference's engine: a condition on a CUDA tensor
reads it back to the host.
"""

from __future__ import annotations

import inspect
import os
from typing import Any

__all__ = ["val", "ddp_assert", "ddp_assert_any_of", "ddp_expect", "Cond"]


def _render(x: Any) -> str:
    r = repr(x)
    return r if len(r) <= 80 else r[:77] + "..."


def _truth(x: Any) -> bool:
    """bool() that reduces array-valued conditions with all()."""
    if hasattr(x, "all") and getattr(x, "ndim", 0) != 0:
        return bool(x.all())
    return bool(x)


class Cond:
    """A decomposed condition: operator + rendered operand values."""

    def __init__(self, passed: bool, text: str):
        self.passed = passed
        self.text = text

    def __bool__(self) -> bool:
        return self.passed

    def __repr__(self) -> str:
        return f"Cond({'pass' if self.passed else 'FAIL'}: {self.text})"


class val:  # noqa: N801 — reads as a value marker at call sites
    """Comparison-capturing proxy (≙ the lhs wrapper the reference's
    expression decomposer builds, assertions.hpp:204-240)."""

    def __init__(self, v: Any, name: str | None = None):
        self.v = v
        self.name = name

    def _show(self) -> str:
        if self.name is not None:
            return f"{self.name} = {_render(self.v)}"
        return _render(self.v)

    def _cmp(self, other: Any, op: str, result: Any) -> Cond:
        rhs = other._show() if isinstance(other, val) else _render(other)
        return Cond(_truth(result), f"{self._show()} {op} {rhs}")

    def _other(self, other: Any) -> Any:
        return other.v if isinstance(other, val) else other

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp(other, "==", self.v == self._other(other))

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp(other, "!=", self.v != self._other(other))

    def __lt__(self, other):
        return self._cmp(other, "<", self.v < self._other(other))

    def __le__(self, other):
        return self._cmp(other, "<=", self.v <= self._other(other))

    def __gt__(self, other):
        return self._cmp(other, ">", self.v > self._other(other))

    def __ge__(self, other):
        return self._cmp(other, ">=", self.v >= self._other(other))

    def __bool__(self):
        return _truth(self.v)


def _as_cond(c: Any) -> Cond:
    if isinstance(c, Cond):
        return c
    if isinstance(c, val):
        return Cond(_truth(c.v), c._show())
    return Cond(_truth(c), _render(c))


def _caller(depth: int = 2) -> tuple[str, int]:
    fr = inspect.stack()[depth]
    return os.path.basename(fr.filename), fr.lineno


def _report(kind: str, msg: str, conds: list[Cond], file: str, line: int) -> str:
    lines = [f"{kind} failed at {file}:{line}" + (f": {msg}" if msg else "")]
    for c in conds:
        mark = "passed" if c.passed else "FAILED"
        lines.append(f"  [{mark}] {c.text}")
    text = "\n".join(lines)
    _native_report(kind, text, file, line, msg)
    return text


def _native_report(kind: str, expr: str, file: str, line: int, msg: str) -> None:
    """Hook for the native colored reporter (``ddp_tpu``'s routes the report
    through ``cpp/ddp_runtime.cpp``'s ``ddp_report_failure`` when that library
    is loaded).  A no-op here until the port has ``utils/native.py``; the
    report still reaches the caller in the ``AssertionError``'s text."""
    del kind, expr, file, line, msg


def ddp_assert(*conds: Any, msg: str = "") -> None:
    """All-of assert: every condition must hold; on failure every conjunct
    is reported with decomposed operand values, then AssertionError is
    raised (≙ DDP_ASSERT_MSG_ALL_OF)."""
    cs = [_as_cond(c) for c in conds]
    if all(c.passed for c in cs):
        return
    file, line = _caller()
    raise AssertionError(_report("assertion (all_of)", msg, cs, file, line))


def ddp_assert_any_of(*conds: Any, msg: str = "") -> None:
    """Any-of assert: at least one condition must hold
    (≙ DDP_ASSERT_MSG_ANY_OF)."""
    cs = [_as_cond(c) for c in conds]
    if any(c.passed for c in cs):
        return
    file, line = _caller()
    raise AssertionError(_report("assertion (any_of)", msg, cs, file, line))


def ddp_expect(*conds: Any, msg: str = "") -> bool:
    """Non-fatal flavor (≙ DDP_EXPECT): prints the decomposed report and
    returns False instead of raising."""
    cs = [_as_cond(c) for c in conds]
    if all(c.passed for c in cs):
        return True
    file, line = _caller()
    print(_report("expectation (all_of)", msg, cs, file, line))
    return False
