"""Discrete-time dynamics on the state manifold (≙ ddp_tpu/ocp/dynamics.py).

``EulerDynamics`` matches the reference discretization:

    q' = q ⊕ (dt · v)
    v' = v + dt · FD(q, v, u)

The model is the closed-form pendulum or a ``RobotModel``.  ``RK4Dynamics``
is a classical RK4 step on the same manifold (not in the reference).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import jacfwd, vmap

from ddp_tpu_torch.models.base import state_pack, state_split


def _vector_space_config(model) -> bool:
    """True iff the configuration space is a vector space (integrate is
    addition, difference is subtraction, tangent == coordinates).

    Closed-form models must opt in explicitly (``model.vector_space``);
    inferring it from nq == nv would mis-handle a model whose integrate
    wraps angles."""
    jt = getattr(model, "joint_types", None)
    if jt is not None:
        return all(t in ("revolute", "prismatic") for t in jt)
    return bool(getattr(model, "vector_space", False))


class EulerDynamics(nn.Module):
    def __init__(self, model: nn.Module, dt: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("dt", dt)

    def forward(self, t, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        del t
        model = self.model
        q, v = state_split(model, x)
        a = model.forward_dynamics(q, v, u)
        q_next = model.integrate(q, self.dt * v)
        v_next = v + self.dt * a
        return state_pack(q_next, v_next)

    @property
    def analytic_jacobians_ok(self) -> bool:
        """Whether ``jacobians`` is available and exact for this model: the
        model must expose assembled ∂FD blocks (``fd_derivatives``).  Valid
        for every joint type: manifold configurations chain the blocks
        through the chart."""
        return hasattr(self.model, "fd_derivatives")

    def jacobians(self, t, x: torch.Tensor, u: torch.Tensor):
        """(x_next, fx [..., ndx, ndx], fu [..., ndx, nu]) assembled from the
        Euler-step structure, for any leading batch dims.  Vector-space
        configurations:

            fx = [[I, dt·I], [dt·∂a/∂q, I + dt·∂a/∂v]],  fu = [[0], [dt·∂a/∂u]]

        Manifold configurations (freeflyer, spherical, planar, continuous):
        the dynamics blocks still come from one ``fd_derivatives`` call and
        only the chart maps are differentiated (``jacfwd`` per sample):

            fx = [[d_int_dq, d_int_dv], [dt·(∂a/∂q)·Q, I + dt·∂a/∂v]]

        with Q = ∂ integrate(q, δ)/∂δ at 0 (coordinates → tangent) and
        d_int_dq/dv the Jacobians of q ⊕ dt·v in tangent coordinates."""
        del t
        model = self.model
        dt = self.dt
        q, v = state_split(model, x)
        a, A, Bv, Bu = model.fd_derivatives(q, v, u)
        nv, nu = Bv.shape[-1], u.shape[-1]
        batch = Bv.shape[:-2]
        I = torch.eye(nv, dtype=x.dtype, device=x.device).expand(batch + (nv, nv))
        if _vector_space_config(model):
            top = torch.cat([I, dt * I], dim=-1)
        else:
            Q, d_int_dq, d_int_dv = _chart_jacobians(model, q, v, dt, batch)
            A = A @ Q
            top = torch.cat([d_int_dq, d_int_dv], dim=-1)
        fx = torch.cat([top, torch.cat([dt * A, I + dt * Bv], dim=-1)], dim=-2)
        zeros = torch.zeros(batch + (nv, nu), dtype=x.dtype, device=x.device)
        fu = torch.cat([zeros, dt * Bu], dim=-2)
        x_next = state_pack(model.integrate(q, dt * v), v + dt * a)
        return x_next, fx, fu


def _chart_jacobians(model, q, v, dt, batch):
    """(Q [..., nq, nv], d_int_dq [..., nv, nv], d_int_dv [..., nv, nv]) of
    the Euler q-row on a manifold configuration, one ``jacfwd`` of the chart
    maps per sample (``vmap`` over the flattened leading dims)."""
    nq, nv = model.nq, model.nv
    qf = q.expand(batch + (nq,)).reshape(-1, nq)
    vf = v.expand(batch + (nv,)).reshape(-1, nv)
    z = torch.zeros(nv, dtype=q.dtype, device=q.device)

    def chart(d, q_):
        return model.integrate(q_, d)

    def transport_q(d, q_, v_):
        q1 = model.integrate(q_, dt * v_)
        return model.difference(q1, model.integrate(model.integrate(q_, d), dt * v_))

    def transport_v(dv, q_, v_):
        q1 = model.integrate(q_, dt * v_)
        return model.difference(q1, model.integrate(q_, dt * (v_ + dv)))

    Q = vmap(jacfwd(chart), in_dims=(None, 0))(z, qf)
    d_int_dq = vmap(jacfwd(transport_q), in_dims=(None, 0, 0))(z, qf, vf)
    d_int_dv = vmap(jacfwd(transport_v), in_dims=(None, 0, 0))(z, qf, vf)
    return (
        Q.reshape(batch + (nq, nv)),
        d_int_dq.reshape(batch + (nv, nv)),
        d_int_dv.reshape(batch + (nv, nv)),
    )


class RK4Dynamics(nn.Module):
    """Classical RK4 on the (q, v) manifold, the tangent increments
    retracted once.  Not in the reference; a larger dt at equal accuracy.
    Has no assembled Jacobians: the problem layer takes its generic path."""

    def __init__(self, model: nn.Module, dt: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("dt", dt)

    def forward(self, t, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        del t
        model = self.model
        dt = self.dt

        def xdot(q, v):
            return v, model.forward_dynamics(q, v, u)

        q0, v0 = state_split(model, x)
        k1q, k1v = xdot(q0, v0)
        k2q, k2v = xdot(model.integrate(q0, 0.5 * dt * k1q), v0 + 0.5 * dt * k1v)
        k3q, k3v = xdot(model.integrate(q0, 0.5 * dt * k2q), v0 + 0.5 * dt * k2v)
        k4q, k4v = xdot(model.integrate(q0, dt * k3q), v0 + dt * k3v)
        dq = (dt / 6.0) * (k1q + 2 * k2q + 2 * k3q + k4q)
        dv = (dt / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
        return state_pack(model.integrate(q0, dq), v0 + dv)


def _dt_like(model: nn.Module, dt: float) -> torch.Tensor:
    ref = next(model.buffers())
    return torch.tensor(dt, dtype=ref.dtype, device=ref.device)


def euler(model: nn.Module, dt: float) -> EulerDynamics:
    """Euler dynamics with ``dt`` on the model's device and dtype."""
    return EulerDynamics(model, _dt_like(model, dt))


def rk4(model: nn.Module, dt: float) -> RK4Dynamics:
    """RK4 dynamics with ``dt`` on the model's device and dtype."""
    return RK4Dynamics(model, _dt_like(model, dt))
