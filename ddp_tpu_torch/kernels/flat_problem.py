"""The problem as data for the flat-lane kernels (≙ ``_pack_problem`` of
ddp_tpu/kernels/linesearch_flat.py).

The flat-lane kernels (``kernels/linesearch_flat.py``,
``kernels/flat_solve.py``) run the problem's dynamics, cost and constraint
inside the kernel.  Their CUDA sources are fixed: a problem class is a policy
struct of device functions in ``csrc/flat_problem.cuh``, and a ``Problem`` of
that class reaches the kernel as a small buffer of constants.  ``pack_problem``
recognises the class from the Problem's modules and raises a ``ValueError``
naming the part that lies outside it; there is no route to another backend.

Class ported so far (``PENDULUM_EULER_TARGET``): the closed-form ``Pendulum``
under ``EulerDynamics``, ``QuadControlCost``, and ``NoConstraint`` or a
``ConfigTarget`` under any number of ``AdvanceTime`` layers over the same
dynamics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ddp_tpu_torch.models.pendulum import Pendulum
from ddp_tpu_torch.ocp.constraints import AdvanceTime, ConfigTarget, NoConstraint
from ddp_tpu_torch.ocp.costs import QuadControlCost
from ddp_tpu_torch.ocp.dynamics import EulerDynamics

# class ids, as the dispatch in the CUDA sources numbers them
PENDULUM_EULER_TARGET = 0
# (nx, m, e) the CUDA sources instantiate for that class
KERNEL_DIMS = ((2, 1, 1), (2, 1, 0))


class FlatProblem(NamedTuple):
    """A flat-lane problem as the kernels take it."""

    class_id: int
    nx: int
    m: int
    e: int
    consts: torch.Tensor  # [5] mass, length, dt, c, target (0 without a constraint)
    advance: int  # AdvanceTime layers around the target
    mask: np.ndarray  # [T, e] static 0/1 activity of the constraint rows
    active_ts: tuple  # the ConfigTarget's own schedule (before the layers)
    horizon: int

    def spec(self) -> dict:
        """``convert.problem_from_numpy``'s spec of the problem packed here."""
        mass, length, dt, c, target = (float(v) for v in self.consts.cpu())
        return dict(
            mass=mass, length=length, dt=dt, c=c,
            target=np.array([target]) if self.e else None,
            active_ts=self.active_ts, advance_times=self.advance,
            horizon=self.horizon, second_order=False,
        )  # fmt: skip


def pack_problem(problem) -> FlatProblem:
    """The constants of ``problem`` for the flat-lane kernels, on the problem's
    device and in its dtype.  Raises ``ValueError`` for a problem outside the
    classes ported so far, naming the part that is."""

    def outside(what):
        return ValueError(
            f"{what} is not in the flat-lane class ported so far (closed-form "
            "Pendulum, EulerDynamics, QuadControlCost, NoConstraint or a "
            "ConfigTarget under AdvanceTime layers)"
        )

    dyn = problem.dynamics
    if not isinstance(dyn, EulerDynamics):
        raise outside(f"{type(dyn).__name__} dynamics")
    model = dyn.model
    con, advance = problem.constraint, 0
    while isinstance(con, AdvanceTime):
        if con.dynamics is not dyn:
            raise outside("an AdvanceTime layer over other dynamics than the problem's")
        con, advance = con.inner, advance + 1
    if isinstance(con, NoConstraint):
        target, active_ts = torch.zeros((), dtype=dyn.dt.dtype, device=dyn.dt.device), ()
    elif isinstance(con, ConfigTarget):
        if con.model is not model:
            raise outside("a ConfigTarget on another model than the dynamics'")
        target, active_ts = con.target, con.active_ts
    else:
        raise outside(f"{type(con).__name__} on a {type(con.model).__name__}")
    if not isinstance(model, Pendulum):
        raise outside(f"a {type(model).__name__} model")
    if not isinstance(problem.cost, QuadControlCost):
        raise outside(f"a {type(problem.cost).__name__} cost")
    consts = torch.stack(
        [model.mass, model.length, dyn.dt, problem.cost.c, target.reshape(()).to(dyn.dt.dtype)]
    ).contiguous()
    return FlatProblem(
        class_id=PENDULUM_EULER_TARGET, nx=2, m=1, e=problem.ne, consts=consts,
        advance=advance, mask=problem.eq_mask(), active_ts=tuple(active_ts),
        horizon=problem.horizon,
    )  # fmt: skip
