"""Solver method and parameters (≙ ddp_tpu/solver/solve.py:31-101).

The reference-faithful while-loop ``solve()`` is still to be ported (ROADMAP
slice D); the batched throughput path is ``solver/batched.py``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Method(enum.Enum):
    """PRIMAL and PRIMAL_DUAL_CONSTANT keep the multiplier state-independent
    (jac pinned to zero); AFFINE gives multipliers a state-feedback term
    re-expanded each iteration.  PRIMAL additionally drops the control-
    feedback correction from the multiplier update: p += μ·eq instead of
    p += μ·(eq + eq_u·k) (see ddp_tpu.solver.solve.Method)."""

    PRIMAL = "primal"
    PRIMAL_DUAL_CONSTANT = "primal_dual_constant_multipliers"
    PRIMAL_DUAL_AFFINE = "primal_dual_affine_multipliers"


class SolverParams(NamedTuple):
    """AL schedule parameters.  w/n default to w = 1/μ, n = 1/μ^0.1.

    - ``w_min``: floor on the inner-convergence tolerance w; None → scaled
      to the dtype as 10·sqrt(eps).
    - ``inner_iters_max``: bound on inner Newton iterations between
      multiplier/μ updates; None → the gate opens only via w or the
      plateau test.
    - ``mu_factor``/``mu_max``: penalty growth on update failure and its cap.
    - ``mult_max``: elementwise clip of the multipliers after each update
      (needed whenever mu_max is finite).
    """

    max_iterations: int
    threshold: float
    mu: float
    reg: float = 0.0
    w: float | None = None
    n: float | None = None
    w_min: float | None = None
    inner_iters_max: int | None = None
    mu_factor: float = 10.0
    mu_max: float | None = None
    mult_max: float | None = None
