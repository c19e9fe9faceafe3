"""Problem aggregate: dynamics + cost + equality constraint + derivatives
(≙ ddp_tpu/ocp/problem.py).

Every trajectory argument of ``derivatives`` carries a leading batch dim:
``xs`` is [B, T+1, nx] and ``us`` is [B, T, nu].  Derivatives are
``torch.func.jacfwd`` of the tangent-space local maps

    l̃(dx, du)  = l(t, x ⊕ dx, u + du)
    f̃(dx, du)  = f(t, x ⊕ dx, u + du) ⊖ f(t, x, u)
    eq̃(dx, du) = eq(t, x ⊕ dx, u + du)

under ``vmap`` over the batch.  Dynamics with assembled Jacobians
(``EulerDynamics.jacobians``, any joint type) give fx, fu directly; others
(RK4) take the generic path: the coordinate Jacobian of the raw next state,
chained through the manifold difference at it.  With ``second_order=True``
(full DDP) the dynamics Hessian is ``jacfwd`` of the assembled Jacobian on
vector-space configurations, else ``jacfwd∘jacfwd`` of f̃, and the
constraint Hessian ``jacfwd∘jacfwd`` at the active steps; with
``second_order=False`` (Gauss-Newton) both are zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import jacfwd, vmap

from ddp_tpu_torch.models.base import state_difference, state_integrate
from ddp_tpu_torch.ocp.dynamics import _vector_space_config


# samples per vmap call of the dynamics-Hessian pass: nz forward directions
# over the assembled Jacobian (itself 2·nv directions of RNEA) are live at
# once for every sample of a chunk
_HESSIAN_CHUNK = 1024


def _chunked(fn, z0, *samples):
    """``fn(z0, *samples)`` over the samples (leading dim) in chunks of
    ``_HESSIAN_CHUNK``, concatenated (each output of a tuple)."""
    n, c = samples[0].shape[0], _HESSIAN_CHUNK
    outs = [fn(z0, *(a[i : i + c] for a in samples)) for i in range(0, n, c)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


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

    def f(self, t, x, u):
        return self.dynamics(t, x, u)

    def l(self, t, x, u):  # noqa: E743 — the reference's name
        return self.cost.stage(t, x, u)

    def lf(self, x):
        return self.cost.terminal(x)

    def eq(self, t, x, u):
        """Unmasked constraint value; the solvers go through ``eq_all`` and
        ``derivatives``, which apply the activity mask."""
        return self.constraint.value(t, x, u)

    def eq_all(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """Masked constraint values of whole trajectories, xs [..., T+1, nx],
        us [..., T, nu] → [..., T, ne]: evaluated only at the active steps,
        zero elsewhere."""
        T, ne = self.horizon, self.ne
        kw = dict(dtype=xs.dtype, device=xs.device)
        out = torch.zeros(us.shape[:-2] + (T, ne), **kw)
        active = self.active_ts()
        if ne == 0 or not active:
            return out
        mask = torch.as_tensor(self.eq_mask(), **kw)
        ts_a = torch.as_tensor(active, device=xs.device)
        out[..., ts_a, :] = self.constraint.value(ts_a, xs[..., ts_a, :], us[..., ts_a, :])
        return out * mask

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

    def _stage_local(self, z, t, x, u):
        """l̃(z) = l(t, x ⊕ dx, u + du) of one sample, z = (dx, du)."""
        ndx = self.ndx
        return self.cost.stage(t, state_integrate(self.model, x, z[:ndx]), u + z[ndx:])

    def _generic_dynamics_derivatives(self, ts, x, u, z0):
        """(lz, fx, fu, lzz, fzz) over flat samples (ts [N], x [N, nx],
        u [N, nu]) for dynamics without assembled Jacobians, or a
        second-order problem on a manifold configuration (≙ ``per_t``):
        the Jacobian of (l, f_raw) over z in one ``jacfwd`` (the primal kept
        as aux), chained through E = ∂(f_raw ⊖ ·)/∂x_next at f_raw; with
        ``second_order`` the Hessians of (l, f_raw ⊖ f(z)) by
        ``jacfwd∘jacfwd``, else lzz alone and fzz None."""
        model = self.model
        ndx = self.ndx

        def g(z, t, x_, u_):
            xp = state_integrate(model, x_, z[:ndx])
            up = u_ + z[ndx:]
            f_raw = self.dynamics(t, xp, up)
            return (self.cost.stage(t, xp, up), f_raw), f_raw

        (lz, fz_raw), f_raw = vmap(jacfwd(g, has_aux=True), in_dims=(None, 0, 0, 0))(
            z0, ts, x, u
        )
        E = vmap(jacfwd(lambda xn, base: state_difference(model, base, xn)))(f_raw, f_raw)
        fz = E @ fz_raw  # [N, ndx, nz]
        if self.second_order:

            def g2(z, t, x_, u_, base):
                xp = state_integrate(model, x_, z[:ndx])
                up = u_ + z[ndx:]
                return self.cost.stage(t, xp, up), state_difference(
                    model, base, self.dynamics(t, xp, up)
                )

            hess = vmap(jacfwd(jacfwd(g2)), in_dims=(None, 0, 0, 0, 0))
            lzz, fzz = _chunked(hess, z0, ts, x, u, f_raw)
        else:
            lzz = vmap(jacfwd(jacfwd(self._stage_local)), in_dims=(None, 0, 0, 0))(z0, ts, x, u)
            fzz = None
        return lz, fz[..., :ndx], fz[..., ndx:], lzz, fzz

    def derivatives(
        self, xs: torch.Tensor, us: torch.Tensor, fx_fu=None, f_hess=None
    ) -> Derivs:
        """All first/second-order derivatives along (xs [B, T+1, nx],
        us [B, T, nu]).

        Cost derivatives and the dynamics Jacobians at every step (assembled
        Euler Jacobians where the dynamics have them, the generic chain
        otherwise); the constraint's value, Jacobian and (``second_order``)
        Hessian only at the statically-active steps (``active_ts``),
        scattered into the dense [B, T, …] arrays.  With ``second_order`` the
        dynamics Hessian is the forward derivative of the assembled Jacobian
        on a vector-space configuration (charts are translations, so
        ∂(J at z)/∂z is the local map's Hessian) and ``jacfwd∘jacfwd`` of
        f̃ elsewhere; without it the f and eq Hessians are zero.

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
        model = self.model
        ndx, nu, ne, T = self.ndx, self.nu, self.ne, self.horizon
        B = xs.shape[0]
        nz = ndx + nu
        kw = dict(dtype=xs.dtype, device=xs.device)
        mask = torch.as_tensor(self.eq_mask(), **kw)
        z0 = torch.zeros(nz, **kw)

        # ---- cost + dynamics: every timestep (≙ per_t_analytic, per_t) ----
        x = xs[:, :-1].reshape(B * T, -1)
        u = us.reshape(B * T, nu)
        ts = torch.arange(T, device=xs.device).repeat(B)

        c = self._stage_local
        fzz = None  # stays None in Gauss-Newton mode: zero Hessian
        # the assembled Jacobians where the dynamics have them; in full DDP
        # only on a vector-space configuration (≙ the analytic2 condition)
        assembled = analytic_ok and (not self.second_order or _vector_space_config(model))
        if fx_fu is None and not assembled:
            lz, fx, fu, lzz, fzz = self._generic_dynamics_derivatives(ts, x, u, z0)
        else:
            lz = vmap(jacfwd(c), in_dims=(None, 0, 0, 0))(z0, ts, x, u)
            lzz = vmap(jacfwd(jacfwd(c)), in_dims=(None, 0, 0, 0))(z0, ts, x, u)
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

                    fzz = _chunked(vmap(jacfwd(jac_flat), in_dims=(None, 0, 0, 0)), z0, ts, x, u)
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
