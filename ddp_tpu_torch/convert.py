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


def schedule_from_spec(s):
    """A constraint schedule from its plain form: a sequence of steps, or a
    dict ``{"every_k": k, "offset": o}`` or ``{"in_range": (begin, end)}``."""
    if isinstance(s, dict):
        if "every_k" in s:
            return constraints.every_k(int(s["every_k"]), int(s.get("offset", 0)))
        begin, end = s["in_range"]
        return constraints.in_range(int(begin), int(end))
    return tuple(int(t) for t in s)


def constraint_from_spec(spec: dict, model, dyn, *, device, dtype: torch.dtype):
    """The constraint ``spec`` describes, wrapped in its ``advance_times``
    AdvanceTime layers over ``dyn``.  ``kind``: "none", "config" (``target``
    [nq]), "state" (``target`` [nq + nv]), "frame" (``target`` [3],
    ``frame_id``), "trajectory_config" (``targets`` [T_pad, nq]) or "stack"
    (``parts``, each a spec of its own); every kind but "none" and "stack"
    has an ``active_ts`` schedule (``schedule_from_spec``).  The layers are
    over ``dyn`` unless ``advance_dynamics`` lists them, outermost first,
    each None (``dyn``) or a ``dynamics_from_spec`` spec of pendulum
    dynamics of its own."""

    def tt(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    kind = spec["kind"]
    if kind == "none":
        return constraints.NoConstraint()
    if kind == "stack":
        parts = tuple(
            constraint_from_spec(p, model, dyn, device=device, dtype=dtype) for p in spec["parts"]
        )
        con = constraints.StackConstraints(parts)
    else:
        ts = schedule_from_spec(spec["active_ts"])
        if kind == "config":
            con = constraints.ConfigTarget(model, tt(spec["target"]), ts)
        elif kind == "state":
            con = constraints.StateTarget(model, tt(spec["target"]), ts)
        elif kind == "frame":
            con = constraints.FrameTarget(model, tt(spec["target"]), int(spec["frame_id"]), ts)
        elif kind == "trajectory_config":
            con = constraints.TrajectoryConfigTarget(model, tt(spec["targets"]), ts)
        else:
            raise ValueError(f"unknown constraint kind {kind!r}")
    times = int(spec.get("advance_times", 0))
    layers = spec.get("advance_dynamics") or [None] * times
    if len(layers) != times:
        raise ValueError(f"advance_dynamics lists {len(layers)} layers for advance_times={times}")
    for layer in reversed(layers):  # outermost first
        con = constraints.AdvanceTime(con, dyn if layer is None else dynamics_from_spec(layer, device=device, dtype=dtype))
    return con


def dynamics_from_spec(spec: dict, *, device, dtype: torch.dtype):
    """Pendulum dynamics from ``discretization`` ("euler", the default, or
    "rk4"), ``dt``, ``mass`` and ``length``."""
    model = pendulum(float(spec["mass"]), float(spec["length"]), device=device, dtype=dtype)
    discretize = {"euler": dynamics.euler, "rk4": dynamics.rk4}[spec.get("discretization", "euler")]
    return discretize(model, float(spec["dt"]))


def cost_from_spec(spec: dict, model, *, device, dtype: torch.dtype):
    """The cost ``spec`` describes: ``kind`` "quad_control" (``c``),
    "quad_tracking" (``x_ref``, ``q_diag``, ``r_diag``, ``qf_diag``) or
    "manifold_tracking" (``x_ref``, ``q_diag``, ``v_diag``, ``r_diag``,
    ``terminal_scale``)."""

    def tt(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    kind = spec["kind"]
    if kind == "quad_control":
        return costs.quad_control(float(spec["c"]), device=device, dtype=dtype)
    if kind == "quad_tracking":
        return costs.QuadTrackingCost(*(tt(spec[k]) for k in ("x_ref", "q_diag", "r_diag", "qf_diag")))
    if kind == "manifold_tracking":
        keys = ("x_ref", "q_diag", "v_diag", "r_diag", "terminal_scale")
        return costs.ManifoldTrackingCost(model, *(tt(spec[k]) for k in keys))
    raise ValueError(f"unknown cost kind {kind!r}")


def problem_from_numpy(spec: dict, *, device, dtype: torch.dtype) -> Problem:
    """The problem described by ``spec``:

    - the model: ``robot`` (``robot_model_from_numpy``'s leaves), else the
      pendulum ``mass``, ``length``; ``dt``: the step of the
      ``discretization`` ("euler", the default, or "rk4");
    - the cost: ``cost`` (``cost_from_spec``), else ``c``, the weight of
      l = ½·c·‖u‖²;
    - the constraint: ``constraint`` (``constraint_from_spec``), else the
      short form — ``target`` [3] with ``frame_id`` is a FrameTarget,
      ``target`` [nq] alone a ConfigTarget, either at ``active_ts`` and
      wrapped in ``advance_times`` AdvanceTime layers; ``target`` None (or
      absent) is NoConstraint, whatever ``advance_times`` says;
    - ``horizon``, ``second_order``: the Problem's.
    """
    if "robot" in spec:
        model = robot_model_from_numpy(spec["robot"], device=device, dtype=dtype)
    else:
        model = pendulum(float(spec["mass"]), float(spec["length"]), device=device, dtype=dtype)
    discretize = {"euler": dynamics.euler, "rk4": dynamics.rk4}[spec.get("discretization", "euler")]
    dyn = discretize(model, float(spec["dt"]))
    kw = dict(device=device, dtype=dtype)
    if "constraint" in spec:
        constraint = constraint_from_spec(spec["constraint"], model, dyn, **kw)
    elif spec.get("target") is None:
        constraint = constraints.NoConstraint()
    else:
        short = dict(
            kind="frame" if "frame_id" in spec else "config",
            target=spec["target"], active_ts=spec["active_ts"],
            advance_times=spec["advance_times"], frame_id=spec.get("frame_id"),
        )  # fmt: skip
        constraint = constraint_from_spec(short, model, dyn, **kw)
    cost_spec = spec.get("cost", dict(kind="quad_control", c=spec.get("c")))
    return Problem(
        dynamics=dyn,
        cost=cost_from_spec(cost_spec, model, **kw),
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
