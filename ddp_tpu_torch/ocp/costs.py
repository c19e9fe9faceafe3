"""Stage/terminal cost API (≙ ddp_tpu/ocp/costs.py).

Costs are ``nn.Module``s with ``stage(t, x, u)`` and ``terminal(x)`` written
for any leading batch dims (the last dim is the state/control); derivatives
are taken by the problem layer with ``torch.func.jacfwd`` in tangent
coordinates.
"""

from __future__ import annotations

import torch
from torch import nn

from ddp_tpu_torch.models.base import state_difference


class QuadControlCost(nn.Module):
    """l = ½·c·‖u‖², lf = 0 — the reference's cost."""

    def __init__(self, c: torch.Tensor):
        super().__init__()
        self.register_buffer("c", c)

    def stage(self, t, x, u):
        del t, x
        return 0.5 * self.c * torch.sum(u * u, dim=-1)

    def terminal(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


class QuadTrackingCost(nn.Module):
    """Quadratic state-tracking and control cost, compared coordinate-wise
    (vector-space models; a quaternion state wants ``ManifoldTrackingCost``):

        l  = ½ (x − x_ref)ᵀ Qdiag (x − x_ref) + ½ uᵀ Rdiag u
        lf = ½ (x − x_ref)ᵀ Qfdiag (x − x_ref)
    """

    def __init__(self, x_ref, q_diag, r_diag, qf_diag):
        super().__init__()
        for name, v in dict(x_ref=x_ref, q_diag=q_diag, r_diag=r_diag, qf_diag=qf_diag).items():
            self.register_buffer(name, v)

    # ½·s is written s / 2 (the same bits): under torch.func.jacfwd a Python
    # float times a 0-dim reduction gives float64 tangents in float32
    # problems, and integer 2 keeps the problem's dtype

    def stage(self, t, x, u):
        del t
        e = x - self.x_ref
        return torch.sum(e * self.q_diag * e, dim=-1) / 2 + torch.sum(u * self.r_diag * u, dim=-1) / 2

    def terminal(self, x):
        e = x - self.x_ref
        return torch.sum(e * self.qf_diag * e, dim=-1) / 2


class ManifoldTrackingCost(nn.Module):
    """Tracking cost through the model's manifold difference, right for
    quaternion-bearing states:

        l = ½ dqᵀ Qq dq + ½ dvᵀ Qv dv + ½ uᵀ R u,  (dq, dv) = x ⊖ x_ref
        lf = terminal_scale · (½ dqᵀ Qq dq + ½ dvᵀ Qv dv)
    """

    def __init__(self, model, x_ref, q_diag, v_diag, r_diag, terminal_scale):
        super().__init__()
        self.model = model
        for name, v in dict(
            x_ref=x_ref, q_diag=q_diag, v_diag=v_diag, r_diag=r_diag,
            terminal_scale=terminal_scale,
        ).items():  # fmt: skip
            self.register_buffer(name, v)

    def _state_err(self, x):
        e = state_difference(self.model, self.x_ref, x)
        nv = self.model.nv
        return e[..., :nv], e[..., nv:]

    def stage(self, t, x, u):  # ½·s as s / 2: see QuadTrackingCost
        del t
        dq, dv = self._state_err(x)
        return (
            torch.sum(dq * self.q_diag * dq, dim=-1) / 2
            + torch.sum(dv * self.v_diag * dv, dim=-1) / 2
            + torch.sum(u * self.r_diag * u, dim=-1) / 2
        )

    def terminal(self, x):
        dq, dv = self._state_err(x)
        return self.terminal_scale * (
            torch.sum(dq * self.q_diag * dq, dim=-1) / 2 + torch.sum(dv * self.v_diag * dv, dim=-1) / 2
        )


def quad_control(
    c: float = 1.0, *, device: torch.device | str, dtype: torch.dtype
) -> QuadControlCost:
    return QuadControlCost(torch.tensor(c, dtype=dtype, device=device))
