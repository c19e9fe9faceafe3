"""The port's assertion engine (ddp_tpu_torch/diagnostics/asserts.py), the
same six checks as tests/test_asserts.py with torch tensors in place of JAX
arrays; and solve_batched's preconditions, which raise the same exception in
both packages."""

import numpy as np
import pytest
import torch

from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.diagnostics.asserts import ddp_assert, ddp_assert_any_of, ddp_expect, val
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

from torch_parity_helpers import both_problems


def test_all_of_passes_silently(capsys):
    ddp_assert(val(3) > 2, val("a") == "a", msg="fine")
    assert capsys.readouterr().out == ""


def test_failure_reports_every_conjunct_with_values():
    mu = 0.5
    T = 10
    with pytest.raises(AssertionError) as exc:
        ddp_assert(
            val(mu, "mu") > 1.0,
            val(T, "T") == 10,
            val(2 * T) < T,
            msg="solver preconditions",
        )
    text = str(exc.value)
    # the failing conjuncts show operator and both operand values
    assert "[FAILED] mu = 0.5 > 1.0" in text
    assert "[passed] T = 10 == 10" in text
    assert "[FAILED] 20 < 10" in text
    assert "solver preconditions" in text
    # caller location is captured
    assert "test_torch_asserts.py" in text


def test_any_of_semantics():
    ddp_assert_any_of(val(1) > 2, val(3) > 2)  # one holds → ok
    with pytest.raises(AssertionError) as exc:
        ddp_assert_any_of(val(1) > 2, val(1) > 3, msg="no branch")
    assert str(exc.value).count("[FAILED]") == 2


def test_expect_is_nonfatal(capsys):
    assert ddp_expect(val(1) == 1) is True
    assert ddp_expect(val(1) == 2, msg="soft") is False
    out = capsys.readouterr().out
    assert "expectation" in out and "1 == 2" in out


def test_array_conditions_reduce_with_all():
    x = torch.tensor([1.0, 2.0, 3.0])
    ddp_assert(val(x) > 0.0)  # all positive → passes
    with pytest.raises(AssertionError):
        ddp_assert(val(x) > 1.5, msg="not all above")
    assert ddp_expect(val(np.asarray([True, True]))) is True


def test_plain_bool_conditions_still_work():
    ddp_assert(True, 1 == 1)
    with pytest.raises(AssertionError):
        ddp_assert(True, False, msg="bare bool")


@pytest.mark.parametrize(
    "shape,iters", [((2, 3), 8), ((2,), 8), ((2, 2), 0)], ids=["state_dim", "ndim", "iterations"]
)
def test_solve_batched_preconditions_raise_alike(shape, iters):
    """The same bad x0s (or max_iterations) raises the same exception type,
    with the same message, from both packages' solve_batched."""
    jp, tp = both_problems(4, np.float64)
    x0s = np.zeros(shape)
    kw = dict(max_iterations=iters, threshold=1e-5, mu=1e4)
    raised = []
    for solve, params, x in (
        (jbatched.solve_batched, JParams(**kw), x0s),
        (tbatched.solve_batched, SolverParams(**kw), torch.from_numpy(x0s)),
    ):
        with pytest.raises(Exception) as exc:
            solve(jp if solve is jbatched.solve_batched else tp, params, x)
        raised.append(exc.value)
    assert [type(e) for e in raised] == [AssertionError, AssertionError]
    # the same decomposed conjuncts, whichever file reports them
    strip = [str(e).split("\n", 1)[1] for e in raised]
    assert strip[0] == strip[1] and "[FAILED]" in strip[0]
