"""The problem as data for the flat-lane kernels (≙ ``_pack_problem`` of
ddp_tpu/kernels/linesearch_flat.py).

The flat-lane kernels (``kernels/linesearch_flat.py``,
``kernels/flat_solve.py``) run the problem's dynamics, cost and constraint
inside the kernel.  The TPU kernels rebuild the problem's pytree per lane and
trace its methods; here the CUDA sources hold one composed policy
(``csrc/flat_problem.cuh``) and a ``Problem`` reaches it as a small buffer of
constants.  ``pack_problem`` walks the Problem's modules and raises a
``ValueError`` naming the part that lies outside the class; there is no route
to another backend.

The class (ddp_tpu's flat kernels take the same, the cart-pole and other
``RobotModel``s aside):

- the closed-form ``Pendulum`` under ``EulerDynamics`` or ``RK4Dynamics``;
- ``QuadControlCost``, ``QuadTrackingCost`` or ``ManifoldTrackingCost``;
- a tree of ``NoConstraint``, ``ConfigTarget``, ``StateTarget`` and
  ``TrajectoryConfigTarget`` leaves, ``StackConstraints`` and any number of
  ``AdvanceTime`` layers, each layer over Euler or RK4 dynamics of a
  ``Pendulum`` of its own (dt, mass and length need not be the problem's);
  schedules are tuples (or ranges), ``every_k`` and ``in_range``.

What changes the shape of the arithmetic is compiled in, one library per
value (``FlatProblem.build``): the problem's integrator, the cost kind and
the constraint's row count E.  Everything else is data in ``consts``
(``LAYOUT`` below): the pendulum and its step, the cost's weights and
reference, and for each leaf its kind, its advance layers (each with its own
integrator, dt, mass and length) and its target or target table; the
schedules reach the kernels as the per-row mask ``Problem.eq_mask()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ddp_tpu_torch.models.pendulum import Pendulum
from ddp_tpu_torch.ocp.constraints import (
    AdvanceTime,
    ConfigTarget,
    EveryK,
    InRange,
    NoConstraint,
    StackConstraints,
    StateTarget,
    TrajectoryConfigTarget,
)
from ddp_tpu_torch.ocp.costs import ManifoldTrackingCost, QuadControlCost, QuadTrackingCost
from ddp_tpu_torch.ocp.dynamics import EulerDynamics, RK4Dynamics

# the integrators, cost kinds and leaf kinds as csrc/flat_problem.cuh numbers them
DYNAMICS = {EulerDynamics: 0, RK4Dynamics: 1}
DISCRETIZATION = ("euler", "rk4")
COSTS = ("quad_control", "quad_tracking", "manifold_tracking")
COST_SIZES = (1, 7, 6)  # constants of each cost kind
LEAVES = ("config", "state", "trajectory_config")
LEAF_KINDS = {ConfigTarget: 0, StateTarget: 1, TrajectoryConfigTarget: 2}
LEAF_ROWS = (1, 2, 1)
LEAF_SLOTS, LAYER_SLOTS = 5, 4

LAYOUT = """consts, in the problem's dtype:
  [0] mass, [1] length, [2] dt                   the problem's dynamics
  [3 .. 3 + COST_SIZES[cost])                    the cost:
      quad_control       c
      quad_tracking      x_ref[2], q_diag[2], r_diag[1], qf_diag[2]
      manifold_tracking  x_ref[2], q_diag, v_diag, r_diag, terminal_scale
  [C] n_leaves, C = 3 + COST_SIZES[cost]
  [C + 1 + 5 l ...]  leaf l: kind, n_layers, layers offset, data offset, n_data
  layers: 4 a layer, outermost first: integrator, dt, mass, length
  data: a leaf's target (1 or 2 values) or its [T_pad] target table"""


class FlatProblem(NamedTuple):
    """A flat-lane problem as the kernels take it."""

    dynamics: int  # the problem's integrator, DYNAMICS' number
    cost: int  # the cost kind, its index in COSTS
    nx: int
    m: int
    e: int
    consts: torch.Tensor  # LAYOUT
    mask: torch.Tensor  # [T, e] 0/1 activity of the constraint rows (Problem.eq_mask)
    tree: tuple  # the constraint's structure for ``spec``: see ``_walk``
    horizon: int
    leaves: tuple  # per leaf: (its kind, its layers' integrators, outermost first)

    @property
    def build(self) -> dict:
        """The build constants of the class (``_build.load``'s ``consts``)."""
        return {"DYN": self.dynamics, "COST": self.cost, "E": self.e}

    @property
    def active_ts(self) -> tuple:
        """The steps with an active constraint row."""
        return tuple(int(t) for t in np.nonzero(self.mask.cpu().numpy().any(axis=1))[0])

    def spec(self) -> dict:
        """``convert.problem_from_numpy``'s spec of the problem packed here,
        its numbers read from the buffer."""
        c = self.consts.cpu().numpy().astype(np.float64)
        own = (self.dynamics, c[2], c[0], c[1])
        base = 3 + COST_SIZES[self.cost]
        leaves = [c[base + 1 + LEAF_SLOTS * i : base + 1 + LEAF_SLOTS * (i + 1)]
                  for i in range(int(c[base]))]  # fmt: skip

        def layer_spec(leaf, depth):
            kind, dt, mass, length = c[int(leaf[2]) + LAYER_SLOTS * depth :][:LAYER_SLOTS]
            if (int(kind), dt, mass, length) == own:
                return None
            return dict(discretization=DISCRETIZATION[int(kind)], dt=dt, mass=mass, length=length)

        def first_leaf(node):
            if node[0] == "leaf":
                return node[1]
            if node[0] == "stack":
                return next((i for i in map(first_leaf, node[1]) if i is not None), None)
            return None

        def node_spec(node, depth):
            layers = node[-1]
            if node[0] == "none":
                out = dict(kind="none")
            elif node[0] == "stack":
                out = dict(kind="stack", parts=[node_spec(p, depth + layers) for p in node[1]])
            else:
                leaf = leaves[node[1]]
                kind, data, n_data = LEAVES[int(leaf[0])], int(leaf[3]), int(leaf[4])
                out = dict(kind=kind, active_ts=node[2])
                if kind == "trajectory_config":
                    out["targets"] = c[data : data + n_data].reshape(n_data, 1)
                else:
                    out["target"] = c[data : data + n_data]
            out["advance_times"] = layers
            index = first_leaf(node)
            if layers and index is not None:
                specs = [layer_spec(leaves[index], depth + i) for i in range(layers)]
                if any(s is not None for s in specs):
                    out["advance_dynamics"] = specs
            return out

        cost = dict(kind=COSTS[self.cost])
        w = c[3:base]
        if self.cost == 0:
            cost["c"] = w[0]
        elif self.cost == 1:
            cost.update(x_ref=w[0:2], q_diag=w[2:4], r_diag=w[4:5], qf_diag=w[5:7])
        else:
            cost.update(x_ref=w[0:2], q_diag=w[2:3], v_diag=w[3:4], r_diag=w[4:5],
                        terminal_scale=w[5])  # fmt: skip
        return dict(
            mass=c[0], length=c[1], dt=c[2], discretization=DISCRETIZATION[self.dynamics],
            cost=cost, constraint=node_spec(self.tree, 0), horizon=self.horizon,
            second_order=False,
        )  # fmt: skip


def _outside(what):
    return ValueError(
        f"{what} is not in the flat-lane class (closed-form Pendulum under Euler or RK4; "
        "QuadControlCost, QuadTrackingCost or ManifoldTrackingCost; NoConstraint, "
        "ConfigTarget, StateTarget and TrajectoryConfigTarget leaves under StackConstraints "
        "and AdvanceTime layers over Pendulum dynamics)"
    )


def _schedule(ts):
    """A leaf's schedule in ``convert.schedule_from_spec``'s form."""
    if isinstance(ts, EveryK):
        return {"every_k": ts.k, "offset": ts.offset}
    if isinstance(ts, InRange):
        return {"in_range": (ts.begin, ts.end)}
    try:
        return tuple(int(t) for t in ts)
    except TypeError:
        raise _outside(
            f"a {type(ts).__name__} schedule that is not a list of steps, every_k or in_range"
        ) from None


def _walk(con, layers, leaves):
    """The constraint's structure: ("none", n), ("leaf", index, schedule, n)
    or ("stack", children, n), n the AdvanceTime layers directly around the
    node; appends each leaf (the module, its layers' dynamics outermost
    first) to ``leaves``.  Checks the kinds of the leaves only: their models
    and layers are ``pack_problem``'s to check, after the problem's own."""
    n = 0
    while type(con) is AdvanceTime:
        layers, n = layers + (con.dynamics,), n + 1
        con = con.inner
    if type(con) is NoConstraint:
        return ("none", n)
    if type(con) is StackConstraints:
        return ("stack", tuple(_walk(p, layers, leaves) for p in con.parts), n)
    if type(con) not in LEAF_KINDS:
        model = getattr(con, "model", None)
        raise _outside(type(con).__name__ + (f" on a {type(model).__name__}" if model is not None else ""))
    leaves.append((con, layers))
    return ("leaf", len(leaves) - 1, _schedule(con.active_ts), n)


def _leaf_row(con):
    """(leaf kind, its target or target table, flat)."""
    if type(con.model) is not Pendulum:
        raise _outside(f"{type(con).__name__} on a {type(con.model).__name__}")
    kind = LEAF_KINDS[type(con)]
    data = con.targets.reshape(-1) if kind == 2 else con.target.reshape(-1)
    if kind != 2 and data.numel() != LEAF_ROWS[kind]:
        raise _outside(f"a {type(con).__name__} of {data.numel()} values")
    return kind, data


def _layer_row(dyn):
    """(integrator, dt, mass, length) of an AdvanceTime layer's dynamics."""
    if type(dyn) not in DYNAMICS:
        raise _outside(f"an AdvanceTime layer over {type(dyn).__name__}")
    if type(dyn.model) is not Pendulum:
        raise _outside(f"an AdvanceTime layer over a {type(dyn.model).__name__}'s dynamics")
    return DYNAMICS[type(dyn)], dyn.dt, dyn.model.mass, dyn.model.length


def _cost_row(cost):
    """(cost kind, its constants as tensors)."""
    if type(cost) is QuadControlCost:
        return 0, [cost.c.reshape(1)]
    if type(cost) is QuadTrackingCost:
        shapes = ((cost.x_ref, 2), (cost.q_diag, 2), (cost.r_diag, 1), (cost.qf_diag, 2))
        return 1, [torch.broadcast_to(w, (n,)) for w, n in shapes]
    if type(cost) is ManifoldTrackingCost:
        if type(cost.model) is not Pendulum:
            raise _outside(f"a ManifoldTrackingCost on a {type(cost.model).__name__}")
        shapes = ((cost.x_ref, 2), (cost.q_diag, 1), (cost.v_diag, 1), (cost.r_diag, 1),
                  (cost.terminal_scale, 1))  # fmt: skip
        return 2, [torch.broadcast_to(w, (n,)) for w, n in shapes]
    raise _outside(f"a {type(cost).__name__} cost")


def pack_problem(problem) -> FlatProblem:
    """The class, the constants and the constraint mask of ``problem`` for the
    flat-lane kernels, on the problem's device and in its dtype: a caller
    packs once and launches many times.  Raises ``ValueError`` for a problem
    outside the class, naming the part that is: a subclass of a module of
    the class, a ``RobotModel`` anywhere, and a schedule that is neither a
    list of steps nor ``every_k`` nor ``in_range`` are outside it."""
    leaves = []
    tree = _walk(problem.constraint, (), leaves)
    dyn = problem.dynamics
    if type(dyn) not in DYNAMICS:
        raise _outside(f"{type(dyn).__name__} dynamics")
    if type(dyn.model) is not Pendulum:
        raise _outside(f"a {type(dyn.model).__name__} model")
    kind, dt, mass, length = DYNAMICS[type(dyn)], dyn.dt, dyn.model.mass, dyn.model.length
    targets = [_leaf_row(con) for con, _ in leaves]
    rows = [[_layer_row(d) for d in layers] for _, layers in leaves]
    cost, weights = _cost_row(problem.cost)
    dtype, device = dt.dtype, dt.device

    def scalars(*values):
        return torch.tensor(values, dtype=dtype, device=device)

    # offsets: the leaf table, then every leaf's layers, then every leaf's data
    base = 3 + COST_SIZES[cost]
    layers_at = base + 1 + LEAF_SLOTS * len(leaves)
    data_at = layers_at + LAYER_SLOTS * sum(len(r) for r in rows)
    table, layer_parts, data_parts = [], [], []
    for (leaf_kind, data), layer_rows in zip(targets, rows):
        table.append(scalars(leaf_kind, len(layer_rows), layers_at, data_at, data.numel()))
        layers_at += LAYER_SLOTS * len(layer_rows)
        data_at += data.numel()
        for integrator, *params in layer_rows:
            layer_parts.append(torch.cat([scalars(integrator)] + [p.reshape(1).to(dtype) for p in params]))
        data_parts.append(data.to(dtype))
    consts = torch.cat(
        [x.reshape(1).to(dtype) for x in (mass, length, dt)] + [w.to(dtype) for w in weights]
        + [scalars(len(leaves))] + table + layer_parts + data_parts
    ).contiguous()  # fmt: skip
    mask = torch.as_tensor(problem.eq_mask(), dtype=dtype, device=device)
    return FlatProblem(
        dynamics=kind, cost=cost, nx=2, m=1, e=problem.ne, consts=consts, mask=mask,
        tree=tree, horizon=problem.horizon,
        leaves=tuple((k, tuple(r[0] for r in layer_rows)) for (k, _), layer_rows in zip(targets, rows)),
    )  # fmt: skip
