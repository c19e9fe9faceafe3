"""Closed-loop rollout (≙ ddp_tpu/solver/rollout.py::feedback_rollout):

    u_t = u_old_t + step·k_t + K_t·(x_t ⊖ x_old_t);  x_{t+1} = f(t, x_t, u_t)

The serial-halving ``forward_pass`` is part of ROADMAP slice D.
"""

from __future__ import annotations

import torch

from ddp_tpu_torch.models.base import state_difference


def feedback_rollout(problem, xs_old, us_old, k, K, step):
    """One closed-loop rollout for a batch: xs_old [..., T+1, nx],
    us_old/k [..., T, nu], K [..., T, nu, ndx]; ``step`` broadcasts against
    [..., nu].  Returns (xs [..., T+1, nx], us [..., T, nu])."""
    model = problem.model
    x = xs_old[..., 0, :]
    xs, us = [x], []
    for t in range(problem.horizon):
        dx = state_difference(model, xs_old[..., t, :], x)
        u = us_old[..., t, :] + step * k[..., t, :] + (K[..., t, :, :] @ dx[..., None])[..., 0]
        x = problem.dynamics(t, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)
