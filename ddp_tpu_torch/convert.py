"""Build the port's problem from plain parameters, so both packages can be
handed the same problem (the tests fill ``spec`` from a ``ddp_tpu`` Problem's
leaves with ``np.asarray``).  Imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

from ddp_tpu_torch.models.pendulum import pendulum
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem


def problem_from_numpy(spec: dict, *, device, dtype: torch.dtype) -> Problem:
    """The constrained pendulum problem described by ``spec``:

    - ``mass``, ``length``: the pendulum; ``dt``: the Euler step;
    - ``c``: the control-cost weight (l = ½·c·‖u‖²);
    - ``target`` [nq], ``active_ts``: a ConfigTarget constraint, wrapped in
      ``advance_times`` AdvanceTime layers;
    - ``horizon``, ``second_order``: the Problem's.
    """
    model = pendulum(float(spec["mass"]), float(spec["length"]), device=device, dtype=dtype)
    dyn = dynamics.euler(model, float(spec["dt"]))
    target = torch.tensor(np.asarray(spec["target"]), dtype=dtype, device=device)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model, target, tuple(int(t) for t in spec["active_ts"])
        ),
        dyn,
        times=int(spec["advance_times"]),
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(float(spec["c"]), device=device, dtype=dtype),
        constraint=con,
        horizon=int(spec["horizon"]),
        second_order=bool(spec["second_order"]),
    )
