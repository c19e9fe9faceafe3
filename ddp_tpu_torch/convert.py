"""Build the port's models and problems from plain parameters, so both
packages can be handed the same problem (the tests fill ``spec`` from a
``ddp_tpu`` Problem's leaves with ``np.asarray``).  Imports no JAX."""

from __future__ import annotations

import numpy as np
import torch

from ddp_tpu_torch.models.pendulum import pendulum
from ddp_tpu_torch.models.rigid_body import RobotModel
from ddp_tpu_torch.ocp import constraints, costs, dynamics
from ddp_tpu_torch.ocp.problem import Problem
from ddp_tpu_torch.solver.al import AffineMults

_ROBOT_ARRAYS = (
    "jp_rot", "jp_trans", "axes", "inertias", "gravity", "frame_rot",
    "frame_trans", "damping",
)  # fmt: skip
_ROBOT_LIMITS = ("q_lower", "q_upper", "v_limit", "tau_limit")


def robot_model_from_numpy(leaves: dict, *, device, dtype: torch.dtype) -> RobotModel:
    """A ``RobotModel`` from its fields as numpy arrays (``jp_rot``,
    ``jp_trans``, ``axes``, ``inertias``, ``gravity``, ``frame_rot``,
    ``frame_trans``, ``damping``; optional limits) and static tuples
    (``joint_types``, ``parents``, ``frame_bodies``, ``frame_names``,
    ``name``)."""

    def tt(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    limits = {k: tt(leaves[k]) for k in _ROBOT_LIMITS if leaves.get(k) is not None}
    return RobotModel(
        **{k: tt(leaves[k]) for k in _ROBOT_ARRAYS},
        **limits,
        joint_types=tuple(leaves["joint_types"]),
        parents=tuple(int(p) for p in leaves["parents"]),
        frame_bodies=tuple(int(b) for b in leaves.get("frame_bodies", ())),
        frame_names=tuple(leaves.get("frame_names", ())),
        name=leaves.get("name", "robot"),
    )


def problem_from_numpy(spec: dict, *, device, dtype: torch.dtype) -> Problem:
    """The constrained Euler problem described by ``spec``:

    - the model: ``robot`` (``robot_model_from_numpy``'s leaves), else the
      pendulum ``mass``, ``length``; ``dt``: the Euler step;
    - ``c``: the control-cost weight (l = ½·c·‖u‖²);
    - the constraint, wrapped in ``advance_times`` AdvanceTime layers:
      ``target`` [3] with ``frame_id`` is a FrameTarget, ``target`` [nq]
      alone a ConfigTarget, either at ``active_ts``; ``target`` None (or
      absent) is NoConstraint, whatever ``advance_times`` says;
    - ``horizon``, ``second_order``: the Problem's.
    """
    if "robot" in spec:
        model = robot_model_from_numpy(spec["robot"], device=device, dtype=dtype)
    else:
        model = pendulum(float(spec["mass"]), float(spec["length"]), device=device, dtype=dtype)
    dyn = dynamics.euler(model, float(spec["dt"]))
    if spec.get("target") is None:
        constraint = constraints.NoConstraint()
    else:
        target = torch.tensor(np.asarray(spec["target"]), dtype=dtype, device=device)
        active_ts = tuple(int(t) for t in spec["active_ts"])
        if "frame_id" in spec:
            inner = constraints.FrameTarget(model, target, int(spec["frame_id"]), active_ts)
        else:
            inner = constraints.ConfigTarget(model, target, active_ts)
        constraint = constraints.advance_time(inner, dyn, times=int(spec["advance_times"]))
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(float(spec["c"]), device=device, dtype=dtype),
        constraint=constraint,
        horizon=int(spec["horizon"]),
        second_order=bool(spec["second_order"]),
    )


def warm_start_from_numpy(state: dict, *, device, dtype: torch.dtype) -> dict:
    """``solve_batched``'s warm-start keyword arguments from a previous
    result's state as numpy arrays: ``us`` [B, T, nu], ``mults`` (a dict of
    ``val`` [B, T, ne], ``jac`` [B, T, ne, ndx], ``origin`` [B, T, nx]) and
    the per-lane schedule state ``mu``, ``reg``, ``w``, ``n`` [B] — so a
    solve of either package can be continued in the other."""

    def tt(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    kw = {f"{k}_init": tt(state[k]) for k in ("us", "mu", "reg", "w", "n")}
    kw["mults_init"] = AffineMults(**{k: tt(state["mults"][k]) for k in AffineMults._fields})
    return kw
