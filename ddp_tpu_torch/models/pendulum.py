"""Closed-form 1-DoF pendulum (≙ ddp_tpu/models/pendulum.py):
a = -g/l·sin(q) + tau/m; vector-space integrate/difference."""

from __future__ import annotations

import torch
from torch import nn

_G = 9.81


class Pendulum(nn.Module):
    nq = 1
    nv = 1
    nu = 1
    name = "pendulum"
    # integrate/difference really are +/− (no wrapping), so the analytic
    # Euler-Jacobian path is exact (ocp/dynamics.py _vector_space_config)
    vector_space = True

    def __init__(self, mass: torch.Tensor, length: torch.Tensor):
        super().__init__()
        self.register_buffer("mass", mass)
        self.register_buffer("length", length)

    def neutral_configuration(self) -> torch.Tensor:
        return torch.zeros(1, dtype=self.mass.dtype, device=self.mass.device)

    def random_configuration(self, generator: torch.Generator) -> torch.Tensor:
        """q ~ U(-π, π), drawn from an explicit generator (on its device)."""
        u = torch.rand(
            1, generator=generator, dtype=self.mass.dtype, device=generator.device
        )
        return (2.0 * u - 1.0).to(self.mass.device) * torch.pi

    def integrate(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        return q + dq

    def difference(self, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
        return q1 - q0

    def forward_dynamics(self, q, v, tau):
        del v  # no damping, as in the reference model
        return -(_G / self.length) * torch.sin(q) + tau / self.mass

    def fd_derivatives(self, q, v, tau):
        """(a [..., 1], ∂a/∂q, ∂a/∂v, ∂a/∂τ each [..., 1, 1]) closed form."""
        a = self.forward_dynamics(q, v, tau)
        A = (-(_G / self.length) * torch.cos(q))[..., None]
        Bv = torch.zeros_like(A)
        Bu = torch.ones_like(A) / self.mass
        return a, A, Bv, Bu


def pendulum(
    mass: float = 1.0,
    length: float = 1.0,
    *,
    device: torch.device | str,
    dtype: torch.dtype,
) -> Pendulum:
    kw = dict(device=device, dtype=dtype)
    return Pendulum(torch.tensor(mass, **kw), torch.tensor(length, **kw))
