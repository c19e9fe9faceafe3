"""Discrete-time dynamics on the state manifold (≙ ddp_tpu/ocp/dynamics.py).

``EulerDynamics`` matches the reference discretization:

    q' = q ⊕ (dt · v)
    v' = v + dt · FD(q, v, u)

The model is the closed-form pendulum or a ``RobotModel``.  RK4 and the
analytic Jacobians on manifold configurations are still to be ported
(ROADMAP slice B, item 7).
"""

from __future__ import annotations

import torch
from torch import nn

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
        model must expose assembled ∂FD blocks (``fd_derivatives``)."""
        return hasattr(self.model, "fd_derivatives")

    def jacobians(self, t, x: torch.Tensor, u: torch.Tensor):
        """(x_next, fx [..., ndx, ndx], fu [..., ndx, nu]) assembled from the
        Euler-step structure, for any leading batch dims:

            fx = [[I, dt·I], [dt·∂a/∂q, I + dt·∂a/∂v]],  fu = [[0], [dt·∂a/∂u]]
        """
        del t
        model = self.model
        if not _vector_space_config(model):
            raise NotImplementedError(
                "analytic Euler Jacobians on manifold configurations are "
                "still to be ported (ROADMAP slice B, item 7)"
            )
        dt = self.dt
        q, v = state_split(model, x)
        a, A, Bv, Bu = model.fd_derivatives(q, v, u)
        nv, nu = Bv.shape[-1], u.shape[-1]
        batch = Bv.shape[:-2]
        I = torch.eye(nv, dtype=x.dtype, device=x.device).expand(batch + (nv, nv))
        top = torch.cat([I, dt * I], dim=-1)
        fx = torch.cat([top, torch.cat([dt * A, I + dt * Bv], dim=-1)], dim=-2)
        zeros = torch.zeros(batch + (nv, nu), dtype=x.dtype, device=x.device)
        fu = torch.cat([zeros, dt * Bu], dim=-2)
        x_next = state_pack(model.integrate(q, dt * v), v + dt * a)
        return x_next, fx, fu


def euler(model: nn.Module, dt: float) -> EulerDynamics:
    """Euler dynamics with ``dt`` on the model's device and dtype."""
    ref = next(model.buffers())
    return EulerDynamics(model, torch.tensor(dt, dtype=ref.dtype, device=ref.device))
