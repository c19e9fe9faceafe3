"""Problem aggregate: dynamics + cost + equality constraint + derivatives
(≙ ddp_tpu/ocp/problem.py).

Every trajectory argument carries a leading batch dim: ``xs`` is
[B, T+1, nx] and ``us`` is [B, T, nu].  Derivatives are ``torch.func.jacfwd``
of the tangent-space local maps

    l̃(dx, du)  = l(t, x ⊕ dx, u + du)
    eq̃(dx, du) = eq(t, x ⊕ dx, u + du)

under ``vmap`` over the batch, with the dynamics Jacobians assembled from the
Euler-step structure (``EulerDynamics.jacobians``).  Only the Gauss-Newton
mode is ported; full second-order DDP is ROADMAP slice C.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import jacfwd, vmap

from ddp_tpu_torch.models.base import state_integrate


class Derivs(NamedTuple):
    """Struct-of-stacked-arrays derivative storage, batch-major.  Hessian
    layout (outdim, indim_l, indim_r): ``fux[b, t, o, i, j] = ∂²f_o/∂u_i∂x_j``.
    """

    lx: torch.Tensor  # [B, T, ndx]
    lu: torch.Tensor  # [B, T, nu]
    lxx: torch.Tensor  # [B, T, ndx, ndx]
    lux: torch.Tensor  # [B, T, nu, ndx]
    luu: torch.Tensor  # [B, T, nu, nu]
    fx: torch.Tensor  # [B, T, ndx, ndx]
    fu: torch.Tensor  # [B, T, ndx, nu]
    fxx: torch.Tensor  # [B, T, ndx, ndx, ndx]
    fux: torch.Tensor  # [B, T, ndx, nu, ndx]
    fuu: torch.Tensor  # [B, T, ndx, nu, nu]
    eq: torch.Tensor  # [B, T, ne]
    eqx: torch.Tensor  # [B, T, ne, ndx]
    equ: torch.Tensor  # [B, T, ne, nu]
    eqxx: torch.Tensor  # [B, T, ne, ndx, ndx]
    equx: torch.Tensor  # [B, T, ne, nu, ndx]
    equu: torch.Tensor  # [B, T, ne, nu, nu]
    lfx: torch.Tensor  # [B, ndx]
    lfxx: torch.Tensor  # [B, ndx, ndx]


class Problem(nn.Module):
    def __init__(
        self,
        dynamics: nn.Module,
        cost: nn.Module,
        constraint: nn.Module,
        horizon: int,
        second_order: bool = True,
    ):
        super().__init__()
        self.dynamics = dynamics
        self.cost = cost
        self.constraint = constraint
        self.horizon = int(horizon)
        # False → Gauss-Newton/iLQR mode: f and eq Hessians are zero
        self.second_order = bool(second_order)

    @property
    def model(self):
        return self.dynamics.model

    @property
    def nx(self) -> int:
        return self.model.nq + self.model.nv

    @property
    def ndx(self) -> int:
        return 2 * self.model.nv

    @property
    def nu(self) -> int:
        return self.model.nu

    @property
    def ne(self) -> int:
        return self.constraint.ne

    def eq_mask(self) -> np.ndarray:
        """Static [T, ne] 0/1 activity mask."""
        T, ne = self.horizon, self.ne
        return np.array(
            [[float(self.constraint.active(t))] * ne for t in range(T)],
            dtype=np.float64,
        ).reshape(T, ne)

    def active_ts(self) -> tuple:
        """Static tuple of timesteps with any active constraint row."""
        mask = self.eq_mask()
        return tuple(int(t) for t in np.nonzero(mask.any(axis=1))[0])

    def rollout(self, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """xs[..., 0, :] = x0, xs[..., t+1, :] = f(t, xs[..., t, :], us[..., t, :])."""
        x, xs = x0, [x0]
        for t in range(self.horizon):
            x = self.dynamics(t, x, us[..., t, :])
            xs.append(x)
        return torch.stack(xs, dim=-2)

    def derivatives(self, xs: torch.Tensor, us: torch.Tensor) -> Derivs:
        """All first/second-order derivatives along (xs [B, T+1, nx],
        us [B, T, nu]), Gauss-Newton mode.

        Cost derivatives and assembled Euler Jacobians at every step; the
        constraint's value and Jacobian only at the statically-active steps
        (``active_ts``), scattered into the dense [B, T, …] arrays."""
        if self.second_order:
            raise NotImplementedError(
                "second_order=True (full DDP Hessians) is still to be ported "
                "(ROADMAP slice C); build the Problem with second_order=False"
            )
        if not getattr(self.dynamics, "analytic_jacobians_ok", False):
            raise NotImplementedError(
                "the generic JVP derivative path (models without assembled "
                "fd_derivatives) is still to be ported (ROADMAP slice B)"
            )
        model = self.model
        ndx, nu, ne, T = self.ndx, self.nu, self.ne, self.horizon
        B = xs.shape[0]
        nz = ndx + nu
        kw = dict(dtype=xs.dtype, device=xs.device)
        mask = torch.as_tensor(self.eq_mask(), **kw)
        z0 = torch.zeros(nz, **kw)

        # ---- cost + dynamics: every timestep (≙ per_t_analytic) ----
        x = xs[:, :-1].reshape(B * T, -1)
        u = us.reshape(B * T, nu)
        ts = torch.arange(T, device=xs.device).repeat(B)

        def c(z, t, x_, u_):
            return self.cost.stage(t, state_integrate(model, x_, z[:ndx]), u_ + z[ndx:])

        lz = vmap(jacfwd(c), in_dims=(None, 0, 0, 0))(z0, ts, x, u)
        lzz = vmap(jacfwd(jacfwd(c)), in_dims=(None, 0, 0, 0))(z0, ts, x, u)
        _, fx, fu = self.dynamics.jacobians(ts, x, u)
        lz = lz.reshape(B, T, nz)
        lzz = lzz.reshape(B, T, nz, nz)

        # ---- constraint: statically-active timesteps only ----
        eq0 = torch.zeros(B, T, ne, **kw)
        eqz = torch.zeros(B, T, ne, nz, **kw)
        for t in self.active_ts():

            def h(z, x_, u_, t=t):
                val = self.constraint.value(
                    t, state_integrate(model, x_, z[:ndx]), u_ + z[ndx:]
                )
                return val, val

            jac, val = vmap(jacfwd(h, has_aux=True), in_dims=(None, 0, 0))(
                z0, xs[:, t], us[:, t]
            )
            eq0[:, t] = val
            eqz[:, t] = jac

        def lfg(dx, xT):
            return self.cost.terminal(state_integrate(model, xT, dx))

        dx0 = torch.zeros(ndx, **kw)
        lfx = vmap(jacfwd(lfg), in_dims=(None, 0))(dx0, xs[:, -1])
        lfxx = vmap(jacfwd(jacfwd(lfg)), in_dims=(None, 0))(dx0, xs[:, -1])

        sx = slice(None, ndx)
        su = slice(ndx, None)
        m1 = mask[:, :, None]
        return Derivs(
            lx=lz[..., sx],
            lu=lz[..., su],
            lxx=lzz[..., sx, sx],
            lux=lzz[..., su, sx],
            luu=lzz[..., su, su],
            fx=fx.reshape(B, T, ndx, ndx),
            fu=fu.reshape(B, T, ndx, nu),
            fxx=torch.zeros(B, T, ndx, ndx, ndx, **kw),
            fux=torch.zeros(B, T, ndx, nu, ndx, **kw),
            fuu=torch.zeros(B, T, ndx, nu, nu, **kw),
            eq=eq0 * mask,
            eqx=eqz[..., sx] * m1,
            equ=eqz[..., su] * m1,
            eqxx=torch.zeros(B, T, ne, ndx, ndx, **kw),
            equx=torch.zeros(B, T, ne, nu, ndx, **kw),
            equu=torch.zeros(B, T, ne, nu, nu, **kw),
            lfx=lfx,
            lfxx=lfxx,
        )
