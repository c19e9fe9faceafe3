"""Model protocol and state-space helpers (≙ ddp_tpu/models/base.py).

A *model* is an ``nn.Module`` holding its constants as buffers, with static
dims ``nq``/``nv``/``nu`` and ``integrate``/``difference``/
``forward_dynamics`` written for any number of leading batch dims.  The
state is x = concat(q, v); the tangent state dx has dim ``2 nv``.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def state_pack(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, v], dim=-1)


def state_split(model, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return x[..., : model.nq], x[..., model.nq :]


def state_neutral(model) -> torch.Tensor:
    q = model.neutral_configuration()
    return state_pack(q, torch.zeros(model.nv, dtype=q.dtype, device=q.device))


def state_integrate(model, x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """x ⊕ dx with dx = (dq ∈ T_q Q, dv ∈ R^nv)."""
    q, v = state_split(model, x)
    dq, dv = dx[..., : model.nv], dx[..., model.nv :]
    return state_pack(model.integrate(q, dq), v + dv)


def state_difference(model, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """x1 ⊖ x0 in the tangent space at x0."""
    q0, v0 = state_split(model, x0)
    q1, v1 = state_split(model, x1)
    return torch.cat([model.difference(q0, q1), v1 - v0], dim=-1)


def state_transport(
    model, v: torch.Tensor, x_from: torch.Tensor, x_to: torch.Tensor
) -> torch.Tensor:
    """Parallel-transport a tangent vector v from T_{x_from} to T_{x_to}, to
    first order: J·v with J = d(x_to ⊖ (x_from ⊕ e))/de at e = 0.  One
    sample (no batch dims), as in ddp_tpu.models.base."""

    def chart(e):
        return state_difference(model, x_to, state_integrate(model, x_from, e))

    return jacfwd(chart)(torch.zeros_like(v)) @ v


def state_difference_jacobian(
    model, x0: torch.Tensor, x1: torch.Tensor
) -> torch.Tensor:
    """d(x1 ⊖ x0)/d x1 in tangent coordinates at x1: [..., 2nv, 2nv] with
    (x1 ⊕ e) ⊖ x0 ≈ (x1 ⊖ x0) + J e.  Leading dims are batch dims (one
    ``jacfwd`` per sample under ``vmap``)."""
    batch = torch.broadcast_shapes(x0.shape[:-1], x1.shape[:-1])
    x0f = x0.expand(batch + x0.shape[-1:]).reshape(-1, x0.shape[-1])
    x1f = x1.expand(batch + x1.shape[-1:]).reshape(-1, x1.shape[-1])
    zero = torch.zeros(2 * model.nv, dtype=x1.dtype, device=x1.device)

    def one(e, a, b):
        return state_difference(model, a, state_integrate(model, b, e))

    J = vmap(jacfwd(one), in_dims=(None, 0, 0))(zero, x0f, x1f)
    return J.reshape(batch + J.shape[-2:])
