"""Stage/terminal cost API (≙ ddp_tpu/ocp/costs.py).

Costs are ``nn.Module``s with ``stage(t, x, u)`` and ``terminal(x)`` written
for any leading batch dims (the last dim is the state/control); derivatives
are taken by the problem layer with ``torch.func.jacfwd`` in tangent
coordinates.
"""

from __future__ import annotations

import torch
from torch import nn


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


def quad_control(
    c: float = 1.0, *, device: torch.device | str, dtype: torch.dtype
) -> QuadControlCost:
    return QuadControlCost(torch.tensor(c, dtype=dtype, device=device))
