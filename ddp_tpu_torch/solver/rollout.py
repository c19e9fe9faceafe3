"""Forward pass: closed-loop rollout and backtracking line search on the AL
cost (≙ ddp_tpu/solver/rollout.py):

    u_t = u_old_t + step·k_t + K_t·(x_t ⊖ x_old_t);  x_{t+1} = f(t, x_t, u_t)

accepted iff Σ(cost_new − cost_old) ≤ 0 on the augmented-Lagrangian cost
with the old multipliers; otherwise the step halves, down to ``step_min``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddp_tpu_torch.models.base import state_difference
from ddp_tpu_torch.solver.al import AffineMults, al_costs, full_fp32_matmuls


class ForwardResult(NamedTuple):
    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    step: torch.Tensor  # accepted (or last tried) step length
    accepted: torch.Tensor  # bool


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


@full_fp32_matmuls()
def forward_pass(
    problem,
    xs_old,
    us_old,
    k,
    K,
    mults: AffineMults,
    mu,
    do_linesearch: bool = True,
    step_min: float = 1e-10,
    total_cost=None,
) -> ForwardResult:
    """The serial line search of one trajectory (xs_old [T+1, nx], us_old
    and k [T, nu], K [T, nu, ndx], μ 0-d): step 1, then halved while the
    AL cost rose and the step is at least 2·``step_min``.  Returns the last
    rollout tried, accepted or not, as the reference does.  ``total_cost``
    (xs, us) → Σ AL cost replaces the sum at the problem's dtype (the
    float64 sums of ``solver/precise.py``)."""
    if total_cost is None:

        def total_cost(xs, us):
            return torch.sum(al_costs(problem, xs, us, mults, mu))

    cost_old = total_cost(xs_old, us_old)

    def try_step(step):
        xs, us = feedback_rollout(problem, xs_old, us_old, k, K, step)
        return xs, us, total_cost(xs, us) - cost_old <= 0

    step = torch.ones((), dtype=xs_old.dtype, device=xs_old.device)
    xs, us, accepted = try_step(step)
    if not do_linesearch:
        return ForwardResult(xs=xs, us=us, step=step, accepted=torch.ones((), dtype=torch.bool, device=step.device))
    while not bool(accepted) and bool(step >= 2 * step_min):
        step = step * 0.5
        xs, us, accepted = try_step(step)
    return ForwardResult(xs=xs, us=us, step=step, accepted=accepted)
