"""Shared constructors for the ddp_tpu ↔ ddp_tpu_torch parity tests: the same
problem and the same numpy-seeded inputs handed to both packages."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from ddp_tpu.models import base as jbase
from ddp_tpu.models import robots as jrobots
from ddp_tpu.models.pendulum import pendulum
from ddp_tpu.models.rigid_body import RobotModel as JRobotModel
from ddp_tpu.models.rigid_body import build_model
from ddp_tpu.ocp import constraints, costs, dynamics
from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.ocp.problem import Problem
from ddp_tpu_torch.convert import problem_from_numpy, robot_model_from_numpy
from ddp_tpu_torch.ocp.problem import Derivs as TDerivs

TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def jax_pendulum_problem(horizon, dtype, target=3.14, second_order=False):
    """The headline problem (bench.py): Euler pendulum, ½‖u‖² cost, a
    configuration target at the horizon advanced twice, Gauss-Newton unless
    ``second_order``; ``target`` None is the unconstrained twin."""
    model = pendulum(1.0, 1.0, dtype=dtype)
    dyn = dynamics.euler(model, 0.01)
    if target is None:
        con = constraints.NoConstraint()
    else:
        con = constraints.advance_time(
            constraints.ConfigTarget(
                model=model, target=jnp.asarray([target], dtype), active_ts=(horizon,)
            ),
            dyn,
            times=2,
        )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
        second_order=second_order,
    )


def jax_config_problem(model, target, horizon, second_order=False):
    """A robot reaching a target configuration at the horizon, advanced
    twice: Euler dt = 0.01, ½‖u‖² (the problem of
    tests/test_fd_derivs2_kernel.py's full-DDP solve)."""
    dtype = model.dtype
    dyn = dynamics.euler(model, 0.01)
    con = constraints.advance_time(
        constraints.ConfigTarget(
            model=model, target=jnp.asarray(target, dtype), active_ts=(horizon,)
        ),
        dyn,
        times=2,
    )
    return Problem(
        dynamics=dyn,
        cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con,
        horizon=horizon,
        second_order=second_order,
    )


def robot_leaves(model) -> dict:
    """robot_model_from_numpy's leaves, read from a ddp_tpu RobotModel."""
    arrays = (
        "jp_rot", "jp_trans", "axes", "inertias", "gravity", "frame_rot",
        "frame_trans", "damping", "q_lower", "q_upper", "v_limit", "tau_limit",
    )  # fmt: skip
    leaves = {
        k: None if getattr(model, k) is None else np.asarray(getattr(model, k))
        for k in arrays
    }
    for k in ("joint_types", "parents", "frame_bodies", "frame_names", "name"):
        leaves[k] = getattr(model, k)
    return leaves


def branched_tree(dtype=jnp.float64):
    """A two-branch tree mixing revolute and prismatic joints: body 0 carries
    the chains 1→3 and 2→4→5, so parent ≠ i − 1 and M has structural zeros."""

    def J(i, **kw):
        return dict(mass=1.0 + 0.3 * i, com=[0.02, -0.03, 0.1],
                    inertia=np.diag([0.02, 0.03, 0.01]), **kw)  # fmt: skip

    joints = [
        J(0, type="revolute", parent=-1, axis=[0, 0, 1], placement_trans=[0, 0, 0.2]),
        J(1, type="revolute", parent=0, axis=[0, 1, 0], placement_trans=[0.1, 0, 0.3]),
        J(2, type="prismatic", parent=0, axis=[1, 0, 0], placement_trans=[-0.1, 0.2, 0]),
        J(3, type="revolute", parent=1, axis=[1, 0, 0], placement_trans=[0, 0, 0.25]),
        J(4, type="revolute", parent=2, axis=[0, 1, 1], placement_trans=[0, 0.1, 0.1],
          placement_rot=np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])),
        J(5, type="prismatic", parent=4, axis=[0, 0, 1], placement_trans=[0.05, 0, 0.1]),
    ]  # fmt: skip
    return build_model(joints, name="branched", dtype=dtype)


def both_robots(jmodel):
    """(the ddp_tpu RobotModel, its float64 CPU counterpart in the port)."""
    return jmodel, robot_model_from_numpy(
        robot_leaves(jmodel), device="cpu", dtype=torch.float64
    )


def schedule_spec(ts):
    """``convert.schedule_from_spec``'s plain form of a ddp_tpu schedule."""
    if isinstance(ts, constraints.EveryK):
        return {"every_k": ts.k, "offset": ts.offset}
    if isinstance(ts, constraints.InRange):
        return {"in_range": (ts.begin, ts.end)}
    return tuple(int(x) for x in ts)


def constraint_spec(con, dyn=None) -> dict:
    """``convert.constraint_from_spec``'s spec of a ddp_tpu constraint; an
    AdvanceTime layer over other pendulum dynamics than ``dyn`` (the
    problem's) is listed in ``advance_dynamics``."""
    times, layers = 0, []
    while isinstance(con, constraints.AdvanceTime):
        layer = None
        if dyn is not None and con.dynamics is not dyn:
            layer = dict(
                discretization="rk4" if isinstance(con.dynamics, dynamics.RK4Dynamics) else "euler",
                dt=np.asarray(con.dynamics.dt), mass=np.asarray(con.dynamics.model.mass),
                length=np.asarray(con.dynamics.model.length),
            )  # fmt: skip
        con, times = con.inner, times + 1
        layers.append(layer)
    if isinstance(con, constraints.NoConstraint):
        return dict(kind="none")
    if isinstance(con, constraints.StackConstraints):
        out = dict(kind="stack", parts=[constraint_spec(p, dyn) for p in con.parts])
    else:
        kind = {
            constraints.ConfigTarget: "config", constraints.StateTarget: "state",
            constraints.FrameTarget: "frame", constraints.TrajectoryConfigTarget: "trajectory_config",
        }[type(con)]  # fmt: skip
        out = dict(kind=kind, active_ts=schedule_spec(con.active_ts))
        if kind == "trajectory_config":
            out["targets"] = np.asarray(con.targets)
        else:
            out["target"] = np.asarray(con.target)
        if kind == "frame":
            out["frame_id"] = con.frame_id
    out["advance_times"] = times
    if any(layer is not None for layer in layers):
        out["advance_dynamics"] = layers
    return out


def cost_spec(cost) -> dict:
    """``convert.cost_from_spec``'s spec of a ddp_tpu cost."""
    if isinstance(cost, costs.QuadControlCost):
        return dict(kind="quad_control", c=np.asarray(cost.c))
    if isinstance(cost, costs.QuadTrackingCost):
        keys = ("x_ref", "q_diag", "r_diag", "qf_diag")
        return dict(kind="quad_tracking", **{k: np.asarray(getattr(cost, k)) for k in keys})
    keys = ("x_ref", "q_diag", "v_diag", "r_diag", "terminal_scale")
    return dict(kind="manifold_tracking", **{k: np.asarray(getattr(cost, k)) for k in keys})


def spec_of(problem) -> dict:
    """problem_from_numpy's spec, read from a ddp_tpu Problem's leaves: the
    short form (``target``, ``active_ts``, ``advance_times``, ``c``) where
    the problem has one, the ``constraint``/``cost``/``discretization``
    specs otherwise."""
    con, times = problem.constraint, 0
    while isinstance(con, constraints.AdvanceTime):
        con, times = con.inner, times + 1
    unconstrained = isinstance(con, constraints.NoConstraint)
    short = (
        unconstrained or type(con) in (constraints.ConfigTarget, constraints.FrameTarget)
        and isinstance(con.active_ts, tuple)
    )
    spec = dict(
        dt=np.asarray(problem.dynamics.dt),
        horizon=problem.horizon,
        second_order=problem.second_order,
    )
    if isinstance(problem.dynamics, dynamics.RK4Dynamics):
        spec["discretization"] = "rk4"
    if isinstance(problem.cost, costs.QuadControlCost):
        spec["c"] = np.asarray(problem.cost.c)
    else:
        spec["cost"] = cost_spec(problem.cost)
    if short:
        spec.update(
            target=None if unconstrained else np.asarray(con.target),
            active_ts=() if unconstrained else con.active_ts,
            advance_times=times,
        )
        if isinstance(con, constraints.FrameTarget):
            spec["frame_id"] = con.frame_id
    else:
        spec["constraint"] = constraint_spec(problem.constraint, problem.dynamics)
    if isinstance(problem.model, JRobotModel):
        spec["robot"] = robot_leaves(problem.model)
    else:
        spec.update(
            mass=np.asarray(problem.model.mass), length=np.asarray(problem.model.length)
        )
    return spec


def jax_arm_problem(model, frame_name, q_ready, horizon, second_order=False):
    """The fleet row's problem (bench.py's 7-DoF row) for any revolute/
    prismatic arm: Euler dt = 0.01, ½‖u‖², a FrameTarget at the pose reached
    from ``q_ready`` by 0.04·(1 … nv), active at the horizon and advanced
    twice, Gauss-Newton unless ``second_order``."""
    dtype = model.dtype
    dyn = dynamics.euler(model, 0.01)
    fid = jrobots.ee_frame_id(model, frame_name)
    q_ready = jnp.asarray(q_ready, dtype)
    q_goal = model.integrate(q_ready, jnp.asarray(0.04 * np.arange(1.0, model.nv + 1), dtype))
    con = constraints.advance_time(
        constraints.FrameTarget(
            model=model, target=model.frame_position(fid, q_goal),
            frame_id=fid, active_ts=(horizon,),
        ),
        dyn, times=2,
    )  # fmt: skip
    return Problem(
        dynamics=dyn, cost=costs.quad_control(1.0, dtype=dtype),
        constraint=con, horizon=horizon, second_order=second_order,
    )  # fmt: skip


def arm_inputs(model, q_ready, B, horizon, np_dtype=np.float64):
    """The fleet row's inputs: x0s = (q_ready, 0) + 0.05·N(0, 1) from
    ``default_rng(0)``, us0 = gravity compensation rnea(q, 0, 0) tiled over
    the horizon.  Returns numpy (x0s [B, nx], us0 [B, H, nu])."""
    rng = np.random.default_rng(0)
    dtype = model.dtype
    x0 = jbase.state_pack(jnp.asarray(q_ready, dtype), jnp.zeros(model.nv, dtype))
    x0s = (np.asarray(x0)[None] + 0.05 * rng.standard_normal((B, x0.shape[0]))).astype(np_dtype)
    zero_v = jnp.zeros(model.nv, dtype)
    grav = np.stack(
        [np.asarray(model.rnea(jnp.asarray(q), zero_v, zero_v)) for q in x0s[:, : model.nq]]
    )
    return x0s, np.tile(grav[:, None, :], (1, horizon, 1)).astype(np_dtype)


PANDA_READY = (0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785)


def warm_state_of(result) -> dict:
    """The warm-start state of either package's ``BatchSolveResult`` as
    numpy: ``warm_start_from_numpy``'s input in the port, and (through
    ``jax_warm_start``) ``ddp_tpu``'s ``_init`` arguments."""
    out = {k: np.asarray(getattr(result, k)) for k in ("us", "mu", "reg", "w", "n")}
    out["mults"] = {k: np.asarray(getattr(result.mults, k)) for k in ("val", "jac", "origin")}
    return out


def jax_warm_start(state: dict) -> dict:
    """``ddp_tpu.solver.batched.solve_batched``'s warm-start keyword
    arguments from ``warm_state_of``'s numpy state."""
    from ddp_tpu.solver.al import AffineMults

    kw = {f"{k}_init": jnp.asarray(state[k]) for k in ("us", "mu", "reg", "w", "n")}
    kw["mults_init"] = AffineMults(**{k: jnp.asarray(v) for k, v in state["mults"].items()})
    return kw


def both_problems(horizon, np_dtype, **kw):
    jp = jax_pendulum_problem(horizon, jnp.dtype(np_dtype), **kw)
    return jp, torch_problem(jp, np_dtype)


def torch_problem(jproblem, np_dtype=np.float64):
    """The port's CPU counterpart of a ddp_tpu Problem."""
    return problem_from_numpy(spec_of(jproblem), device="cpu", dtype=TORCH_DTYPE[np_dtype])


def headline_x0s(B, np_dtype):
    """bench.py's initial states: q ~ U(-π, π) from default_rng(0), v = 0."""
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(-np.pi, np.pi, B), np.zeros(B)], axis=1).astype(np_dtype)


def t(x):
    """numpy/JAX array → CPU torch tensor of the same dtype."""
    return torch.from_numpy(np.array(x))


def random_spd_derivs(B, T, n, m, e, seed, np_dtype=np.float64):
    """Random Gauss-Newton derivative blocks [B, T, …] (numpy) at arbitrary
    dims: stable fx near I, a PSD stage-cost Hessian with an SPD luu block,
    non-trivial constraint rows and multipliers.  Returns (fields, pe, pex)."""
    rng = np.random.default_rng(seed)
    nz = n + m
    G = rng.normal(size=(B, T, nz, nz)) / np.sqrt(nz)
    lzz = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(nz)
    lfG = rng.normal(size=(B, n, n)) / np.sqrt(n)
    f = dict(
        lx=rng.normal(size=(B, T, n)),
        lu=rng.normal(size=(B, T, m)),
        lxx=lzz[..., :n, :n],
        lux=lzz[..., n:, :n],
        luu=lzz[..., n:, n:],
        fx=np.eye(n) + 0.05 * rng.normal(size=(B, T, n, n)),
        fu=0.1 * rng.normal(size=(B, T, n, m)),
        fxx=np.zeros((B, T, n, n, n)),
        fux=np.zeros((B, T, n, m, n)),
        fuu=np.zeros((B, T, n, m, m)),
        eq=0.1 * rng.normal(size=(B, T, e)),
        eqx=0.1 * rng.normal(size=(B, T, e, n)),
        equ=0.1 * rng.normal(size=(B, T, e, m)),
        eqxx=np.zeros((B, T, e, n, n)),
        equx=np.zeros((B, T, e, m, n)),
        equu=np.zeros((B, T, e, m, m)),
        lfx=rng.normal(size=(B, n)),
        lfxx=lfG @ np.swapaxes(lfG, -1, -2) + 0.1 * np.eye(n),
    )
    f = {k: np.ascontiguousarray(v, dtype=np_dtype) for k, v in f.items()}
    pe = (0.3 * rng.normal(size=(B, T, e))).astype(np_dtype)
    pex = (0.01 * rng.normal(size=(B, T, e, n))).astype(np_dtype)
    return f, pe, pex


def to_jax_derivs(fields):
    return JDerivs(**{k: jnp.asarray(v) for k, v in fields.items()})


def to_torch_derivs(fields):
    return TDerivs(**{k: t(v) for k, v in fields.items()})


# per-lane factors on the feed-forward gains of ``linesearch_state``: overlong
# steps, so that lanes accept different rungs of the ladder and some none
GAIN_SCALES = (1.5, 2.5, 5.0, 7.0, 11.0, 13.0, 100.0, 1000.0)


def linesearch_state(B, H, np_dtype, constrained=True, seed=0, scale_gains=True, problem=None):
    """A line-search state made with numpy for both packages (≙
    tests/test_pallas_linesearch.py::make_state): the pendulum problem with a
    target of 2.0 (or unconstrained; or the ddp_tpu ``problem`` given, of
    horizon H), a rollout from random x0s and us, random multipliers anchored
    at it, μ = 1e3, and the gains of ddp_tpu's backward sweep at reg = 0,
    lane i's k times ``GAIN_SCALES[i % 8]`` unless ``scale_gains`` is off
    (then every lane accepts the full step).  Returns (jax problem, the
    port's problem, a dict of numpy arrays xs, us, k, K, val, jac, mu)."""
    import jax

    from ddp_tpu.solver import al as jal
    from ddp_tpu.solver.batched import _backward_sweep

    dtype = jnp.dtype(np_dtype)
    jp = problem or jax_pendulum_problem(H, dtype, target=2.0 if constrained else None)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(0.5 * rng.standard_normal((B, 2)), dtype)
    us = jnp.asarray(0.2 * rng.standard_normal((B, H, 1)), dtype)
    xs = jax.vmap(jp.rollout)(x0s, us)
    derivs = jax.vmap(jp.derivatives)(xs, us)
    mults = jax.vmap(lambda x: jal.init_multipliers(jp, x))(xs)
    if jp.ne:
        mults = mults._replace(
            val=jnp.asarray(0.3 * rng.standard_normal(mults.val.shape), dtype),
            jac=jnp.asarray(0.1 * rng.standard_normal(mults.jac.shape), dtype),
        )
    mu = jnp.full((B,), 1e3, dtype)
    k, K, _ = jax.vmap(_backward_sweep)(
        derivs, mults.val, mults.jac, mu, jnp.zeros((B,), dtype)
    )
    if scale_gains:
        factors = np.resize(np.asarray(GAIN_SCALES), B)[:, None, None]
        k = k * jnp.asarray(factors, dtype)
    arrays = dict(xs=xs, us=us, k=k, K=K, val=mults.val, jac=mults.jac, mu=mu)
    return jp, torch_problem(jp, np_dtype), {k_: np.asarray(v) for k_, v in arrays.items()}


# ----------------------------------------------- the flat-lane kernels' class


def jax_problem_from_spec(spec, dtype):
    """ddp_tpu's pendulum Problem of a ``convert.problem_from_numpy`` spec
    (the long form: ``cost`` and ``constraint``), so that both packages build
    one problem from the same numbers."""

    def arr(x):
        return jnp.asarray(np.asarray(x), dtype)

    def pend_dynamics(s):
        model = pendulum(float(s["mass"]), float(s["length"]), dtype=dtype)
        discretize = {"euler": dynamics.euler, "rk4": dynamics.rk4}[s.get("discretization", "euler")]
        return discretize(model, float(s["dt"]))

    dyn = pend_dynamics(spec)
    model = dyn.model

    def schedule(s):
        if isinstance(s, dict):
            if "every_k" in s:
                return constraints.every_k(int(s["every_k"]), int(s.get("offset", 0)))
            return constraints.in_range(*map(int, s["in_range"]))
        return tuple(int(x) for x in s)

    def constraint(s):
        kind = s["kind"]
        if kind == "none":
            return constraints.NoConstraint()
        if kind == "stack":
            con = constraints.StackConstraints(parts=tuple(constraint(p) for p in s["parts"]))
        elif kind == "trajectory_config":
            con = constraints.TrajectoryConfigTarget(model=model, targets=arr(s["targets"]),
                                                     active_ts=schedule(s["active_ts"]))  # fmt: skip
        else:
            cls = {"config": constraints.ConfigTarget, "state": constraints.StateTarget}[kind]
            con = cls(model=model, target=arr(s["target"]), active_ts=schedule(s["active_ts"]))
        layers = s.get("advance_dynamics") or [None] * int(s.get("advance_times", 0))
        for layer in reversed(layers):
            con = constraints.AdvanceTime(inner=con, dynamics=dyn if layer is None else pend_dynamics(layer))
        return con

    c = spec["cost"]
    if c["kind"] == "quad_control":
        cost = costs.quad_control(float(c["c"]), dtype=dtype)
    elif c["kind"] == "quad_tracking":
        cost = costs.QuadTrackingCost(*(arr(c[k]) for k in ("x_ref", "q_diag", "r_diag", "qf_diag")))
    else:
        cost = costs.ManifoldTrackingCost(model, *(arr(c[k]) for k in
                                                   ("x_ref", "q_diag", "v_diag", "r_diag", "terminal_scale")))  # fmt: skip
    return Problem(dynamics=dyn, cost=cost, constraint=constraint(spec["constraint"]),
                   horizon=int(spec["horizon"]), second_order=bool(spec["second_order"]))  # fmt: skip
