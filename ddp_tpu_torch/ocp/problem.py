"""Problem aggregate: dynamics + cost + equality constraint + derivatives
(≙ ddp_tpu/ocp/problem.py).

Every trajectory argument carries a leading batch dim: ``xs`` is
[B, T+1, nx] and ``us`` is [B, T, nu].  Derivatives are ``torch.func.jacfwd``
of the tangent-space local maps

    l̃(dx, du)  = l(t, x ⊕ dx, u + du)
    eq̃(dx, du) = eq(t, x ⊕ dx, u + du)

under ``vmap`` over the batch, with the dynamics Jacobians assembled from the
Euler-step structure (``EulerDynamics.jacobians``).  With
``second_order=True`` (full DDP) the dynamics Hessian is ``jacfwd`` of that
assembled Jacobian and the constraint Hessian ``jacfwd∘jacfwd`` at the active
steps; with ``second_order=False`` (Gauss-Newton) both are zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import jacfwd, vmap

from ddp_tpu_torch.models.base import state_integrate
from ddp_tpu_torch.ocp.dynamics import _vector_space_config


# samples per vmap call of the dynamics-Hessian pass: nz forward directions
# over the assembled Jacobian (itself 2·nv directions of RNEA) are live at
# once for every sample of a chunk
_HESSIAN_CHUNK = 1024


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
        """Static [T, ne] 0/1 activity mask: the constraint's per-row
        ``row_mask(t)`` where it has one, else ``active(t)`` for every row."""
        T, ne = self.horizon, self.ne
        if hasattr(self.constraint, "row_mask"):
            rows = [self.constraint.row_mask(t) for t in range(T)]
            return np.stack(rows).astype(np.float64) if T else np.zeros((0, ne))
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

    def derivatives(
        self, xs: torch.Tensor, us: torch.Tensor, fx_fu=None, f_hess=None
    ) -> Derivs:
        """All first/second-order derivatives along (xs [B, T+1, nx],
        us [B, T, nu]).

        Cost derivatives and assembled Euler Jacobians at every step; the
        constraint's value, Jacobian and (``second_order``) Hessian only at
        the statically-active steps (``active_ts``), scattered into the dense
        [B, T, …] arrays.  With ``second_order`` the dynamics Hessian is the
        forward derivative of the assembled Jacobian, exact on vector-space
        configurations (charts are translations, so ∂(J at z)/∂z is the
        local map's Hessian); without it the f and eq Hessians are zero.

        ``fx_fu``: optional precomputed tangent-space dynamics Jacobians
        (fx [B, T, ndx, ndx], fu [B, T, ndx, nu]) — e.g. from the batched
        fd-derivatives kernels (kernels/fd_derivs.py, kernels/fd_derivs2.py)
        — which replace the ``dynamics.jacobians`` call; ``f_hess``: with
        them, the dynamics Hessian [B, T, ndx, nz, nz] over z = (dx, du),
        which a ``second_order`` problem needs.  Only cost and constraint
        derivatives remain."""
        analytic_ok = getattr(self.dynamics, "analytic_jacobians_ok", False)
        if fx_fu is not None and self.second_order and f_hess is None:
            raise ValueError(
                "precomputed fx_fu without f_hess is first-order (GN) only; "
                "full-DDP callers must supply the dynamics Hessian tensor "
                "(e.g. from kernels/fd_derivs2.py)"
            )
        if f_hess is not None and fx_fu is None:
            raise ValueError("f_hess requires matching fx_fu")
        if fx_fu is not None and not analytic_ok:
            raise ValueError(
                "fx_fu requires dynamics.analytic_jacobians_ok "
                "(dynamics.jacobians is the producer of valid tangent-space "
                "fx/fu); other models need the generic JVP path"
            )
        if not analytic_ok:
            raise NotImplementedError(
                "the generic JVP derivative path (models without assembled "
                "fd_derivatives) is still to be ported (ROADMAP slice B)"
            )
        if self.second_order and fx_fu is None and not _vector_space_config(self.model):
            raise NotImplementedError(
                "second_order=True on manifold configurations needs the "
                "generic jacfwd∘jacfwd path through the manifold difference, "
                "still to be ported (ROADMAP slice B)"
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
        fzz = None  # stays None in Gauss-Newton mode: zero Hessian
        if fx_fu is not None:
            fx, fu = fx_fu
            fzz = f_hess
        else:
            _, fx, fu = self.dynamics.jacobians(ts, x, u)
            if self.second_order:
                # forward-over-assembled-analytic (≙ the analytic2 branch)
                def jac_flat(z, t, x_, u_):
                    _, fx_, fu_ = self.dynamics.jacobians(
                        t, state_integrate(model, x_, z[:ndx]), u_ + z[ndx:]
                    )
                    return torch.cat([fx_, fu_], dim=-1)

                hess = vmap(jacfwd(jac_flat), in_dims=(None, 0, 0, 0))
                fzz = torch.cat(
                    [
                        hess(z0, ts[i : i + _HESSIAN_CHUNK], x[i : i + _HESSIAN_CHUNK],
                             u[i : i + _HESSIAN_CHUNK])
                        for i in range(0, B * T, _HESSIAN_CHUNK)
                    ]
                )  # fmt: skip
        if fzz is None:
            fzz = torch.zeros(B, T, ndx, nz, nz, **kw)
        fzz = fzz.reshape(B, T, ndx, nz, nz)
        lz = lz.reshape(B, T, nz)
        lzz = lzz.reshape(B, T, nz, nz)

        # ---- constraint: statically-active timesteps only ----
        eq0 = torch.zeros(B, T, ne, **kw)
        eqz = torch.zeros(B, T, ne, nz, **kw)
        eqzz = torch.zeros(B, T, ne, nz, nz, **kw)
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
            if self.second_order:
                eqzz[:, t] = vmap(
                    jacfwd(jacfwd(lambda *a: h(*a)[0])), in_dims=(None, 0, 0)
                )(z0, xs[:, t], us[:, t])

        def lfg(dx, xT):
            return self.cost.terminal(state_integrate(model, xT, dx))

        dx0 = torch.zeros(ndx, **kw)
        lfx = vmap(jacfwd(lfg), in_dims=(None, 0))(dx0, xs[:, -1])
        lfxx = vmap(jacfwd(jacfwd(lfg)), in_dims=(None, 0))(dx0, xs[:, -1])

        sx = slice(None, ndx)
        su = slice(ndx, None)
        m1 = mask[:, :, None]
        m2 = mask[:, :, None, None]
        return Derivs(
            lx=lz[..., sx],
            lu=lz[..., su],
            lxx=lzz[..., sx, sx],
            lux=lzz[..., su, sx],
            luu=lzz[..., su, su],
            fx=fx.reshape(B, T, ndx, ndx),
            fu=fu.reshape(B, T, ndx, nu),
            fxx=fzz[..., sx, sx],
            fux=fzz[..., su, sx],
            fuu=fzz[..., su, su],
            eq=eq0 * mask,
            eqx=eqz[..., sx] * m1,
            equ=eqz[..., su] * m1,
            eqxx=eqzz[..., sx, sx] * m2,
            equx=eqzz[..., su, sx] * m2,
            equu=eqzz[..., su, su] * m2,
            lfx=lfx,
            lfxx=lfxx,
        )
