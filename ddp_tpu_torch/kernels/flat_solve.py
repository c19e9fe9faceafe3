"""The whole fixed-budget batched AL-DDP solve in one kernel launch, for
flat-lane problems (≙ ddp_tpu/kernels/flat_solve.py).

``solve_flat`` runs the initial rollout and then, for every iteration of the
budget, the fused derivative + Riccati reverse sweep, the line-searched
rollouts, the gain commit, the re-anchoring of multipliers and gains, both
optimality adjoints and the multiplier / μ / w / n / reg schedule, and the
final measures: the static flow of ``solver/batched.py`` with
``n_reg_levels=1`` and the parallel-sweep acceptance (largest accepted step of
the 2^-c ladder), Gauss-Newton, one active constraint step.

On CUDA tensors it launches ``csrc/flat_solve.cu`` once (a group of threads
per lane runs the lane's whole solve in shared memory, its candidates,
adjoints and per-step derivatives on separate threads; the problem's
dynamics, cost and constraint and their derivatives are the device functions
of its class, ``kernels/flat_problem.py``); on CPU tensors it runs
``solve_flat_reference``, the plain PyTorch version of the same program.

Where the program differs from ``solve_batched``, both versions here keep it:
the constraint rows are evaluated once per iteration at the one active step
and applied behind t == ta; ``ok`` comes from the Cholesky pivots alone;
a lane's trajectory is kept unless it is ok and accepted a step.  One point
follows ``solve_batched`` and not ddp_tpu's kernel: inside the iterations the
feedback gains are anchored at the trajectory they were computed about (the
one before the line search moves it), so the multiplier update's feedback
term agrees with ``solve_batched`` once multiplier updates succeed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels.flat_problem import FlatProblem, pack_problem
from ddp_tpu_torch.ocp.dynamics import _vector_space_config
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.batched import BatchSolveResult
from ddp_tpu_torch.solver.solve import Method

SOURCE = "flat_solve.cu"
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0
_NO_FIT = "flat solve kernel: a lane of horizon {T} with e = {e} does not fit a block's shared memory"


def _setup(problem, params, x0s, us_init, method):
    """The gates of the flat solve and its static description: (method, T, m,
    e, ta, mrow, us_init, scalars)."""
    if method is None:
        method = Method.PRIMAL_DUAL_AFFINE
    if problem.second_order:
        raise ValueError("flat solve kernel is Gauss-Newton only")
    if not _vector_space_config(problem.model):
        raise ValueError("flat solve kernel needs a vector-space model")
    if x0s.dim() != 2 or x0s.shape[-1] != problem.nx:
        raise ValueError(f"x0s must be [B, {problem.nx}], got {tuple(x0s.shape)}")
    B, nx = x0s.shape
    T, m, e = problem.horizon, problem.nu, problem.ne
    if nx != problem.ndx:
        raise ValueError("flat solve kernel needs nx == ndx")
    active = problem.active_ts()
    if len(active) > 1:
        raise ValueError(
            "flat solve kernel supports single-active-step schedules; "
            "use solve_batched for dense/periodic constraint schedules"
        )
    if params.max_iterations < 1:
        raise ValueError("max_iterations must be >= 1")
    dtype, device = x0s.dtype, x0s.device
    ref = next(problem.buffers())
    if ref.device != device or ref.dtype != dtype:
        raise ValueError(
            f"x0s is {dtype} on {device} but the problem is {ref.dtype} on "
            f"{ref.device}; move one with .to(device, dtype)"
        )
    ta = active[0] if active else -1
    mrow = problem.eq_mask()[ta].tolist() if ta >= 0 else [0.0] * e
    if us_init is None:
        us_init = torch.zeros((B, T, m), dtype=dtype, device=device)
    eps = torch.tensor(torch.finfo(dtype).eps, dtype=dtype)
    scalars = dict(
        w_min=float(params.w_min) if params.w_min is not None else float(10.0 * eps**0.5),
        w0=float(params.w) if params.w is not None else 1.0 / params.mu,
        n0=float(params.n) if params.n is not None else 1.0 / params.mu**0.1,
        threshold=float(params.threshold),
        mu_factor=float(params.mu_factor),
    )
    return method, T, m, e, ta, mrow, us_init, scalars


def _chol_solve_rows(A, rhs_list, m):
    """Unrolled Cholesky–Banachiewicz of A (nested lists of [B] vectors) and
    forward/back substitution for each right-hand side; returns (solutions,
    L).  A non-positive pivot gives NaN through sqrt."""
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[i][j]
            for q in range(j):
                s = s - L[i][q] * L[j][q]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    outs = []
    for rhs in rhs_list:
        y = [None] * m
        for i in range(m):
            s = rhs[i]
            for q in range(i):
                s = s - L[i][q] * y[q]
            y[i] = s / L[i][i]
        x = [None] * m
        for i in reversed(range(m)):
            s = y[i]
            for q in range(i + 1, m):
                s = s - L[q][i] * x[q]
            x[i] = s / L[i][i]
        outs.append(x)
    return outs, L


def solve_flat_reference(
    problem,
    params,
    x0s,  # [B, nx]
    us_init=None,  # [B, T, m]
    method=None,
    n_linesearch: int = 8,
):
    """Plain PyTorch version of the kernel: the same per-lane program, stage by
    stage, on [rows, B] slabs with Python loops over t, through the problem's
    own modules (values) and ``torch.func.jacfwd`` of them (derivatives).
    Every input of a per-lane gate (done, plateau, gate, upd_s / upd_f,
    step ≥ ½, Δcost ≤ 0) is computed in the kernel's operation order.
    Returns a ``BatchSolveResult``."""
    method, T, m, e, ta, mrow, us_init, sc = _setup(problem, params, x0s, us_init, method)
    affine = method is Method.PRIMAL_DUAL_AFFINE
    primal = method is Method.PRIMAL
    B, nx = x0s.shape
    nz = nx + m
    kw = dict(dtype=x0s.dtype, device=x0s.device)
    threshold, w_min = sc["threshold"], sc["w_min"]
    zero = torch.zeros(B, **kw)
    one_ = torch.ones(B, **kw)
    constrained = ta >= 0 and e > 0

    def flag(cond):  # bool [B] → 0/1 in the working dtype
        return torch.where(cond, one_, zero)

    # ---- the problem, on [rows, B] slabs ---------------------------------
    def dyn(x, u):
        return problem.dynamics(0, x.T, u.T).T

    def stage(x, u):
        return problem.cost.stage(0, x.T, u.T)

    def term_cost(x):
        return problem.cost.terminal(x.T)

    def eq_value(x, u):
        return problem.constraint.value(ta, x.T, u.T).T  # [e, B]

    z0 = torch.zeros(nz, **kw)

    def gl(z, x, u):
        return problem.cost.stage(0, x + z[:nx], u + z[nx:])

    def gf(z, x, u):
        return problem.dynamics(0, x + z[:nx], u + z[nx:])

    def ge(z, x, u):
        return problem.constraint.value(ta, x + z[:nx], u + z[nx:])

    def gt(dx, x):
        return problem.cost.terminal(x + dx)

    def derivs_all():
        """lz [T, nz, B], lzz [T, nz, nz, B], fz [T, nx, nz, B] along (xs, us);
        the samples of all steps in one vmap."""
        x = xs[:T].permute(0, 2, 1).reshape(T * B, nx)
        u = us.permute(0, 2, 1).reshape(T * B, m)
        dims = (None, 0, 0)
        lz = vmap(jacfwd(gl), in_dims=dims)(z0, x, u)
        lzz = vmap(jacfwd(jacfwd(gl)), in_dims=dims)(z0, x, u)
        fz = vmap(jacfwd(gf), in_dims=dims)(z0, x, u)
        return (
            lz.reshape(T, B, nz).permute(0, 2, 1),
            lzz.reshape(T, B, nz, nz).permute(0, 2, 3, 1),
            fz.reshape(T, B, nx, nz).permute(0, 2, 3, 1),
        )

    def term_grads():
        xT = xs[T].T
        dx0 = torch.zeros(nx, **kw)
        lfx = vmap(jacfwd(gt), in_dims=(None, 0))(dx0, xT)
        lfxx = vmap(jacfwd(jacfwd(gt)), in_dims=(None, 0))(dx0, xT)
        return lfx.T, lfxx.permute(1, 2, 0)

    # ---- state -----------------------------------------------------------
    xs = torch.empty((T + 1, nx, B), **kw)
    us = us_init.permute(1, 2, 0).clone()
    xs[0] = x0s.T
    for t in range(T):
        xs[t + 1] = dyn(xs[t], us[t])
    mval = torch.zeros((T, e, B), **kw)
    mjac = torch.zeros((T, e * nx, B), **kw)
    morig = xs[:T].clone()
    fborig = xs[:T].clone()
    fbk = torch.zeros((T, m, B), **kw)
    fbK = torch.zeros((T, m * nx, B), **kw)
    k_ = torch.zeros((T, m, B), **kw)
    K_ = torch.zeros((T, m * nx, B), **kw)
    xc = torch.empty((T + 1, nx, B), **kw)
    uc = torch.empty((T, m, B), **kw)
    eqr = torch.zeros((max(e, 1) * (1 + nz), B), **kw)

    mu = torch.full((B,), params.mu, **kw)
    reg = torch.full((B,), params.reg, **kw)
    w = torch.full((B,), sc["w0"], **kw)
    n_tol = torch.full((B,), sc["n0"], **kw)
    oo_prev = torch.full((B,), torch.inf, **kw)
    just_changed = one_
    inner = one_

    # ---- stages ------------------------------------------------------------
    def hoist_eq():
        """Constraint value and Jacobian at the active step on the current
        (xs, us), masked, into eqr."""
        if not constrained:
            return
        x, u = xs[ta], us[ta]
        ev = eq_value(x, u)
        ez = vmap(jacfwd(ge), in_dims=(None, 0, 0))(z0, x.T, u.T)  # [B, e, nz]
        for a in range(e):
            eqr[a * (1 + nz)] = ev[a] * mrow[a]
            for j in range(nz):
                eqr[a * (1 + nz) + 1 + j] = ez[:, a, j] * mrow[a]

    def eq_rows(t):
        sel = one_ if t == ta else zero
        eqv = [eqr[a * (1 + nz)] * sel for a in range(e)]
        eqz = [[eqr[a * (1 + nz) + 1 + j] * sel for j in range(nz)] for a in range(e)]
        return eqv, eqz

    def backward(D, mu_, reg_):
        """Fused derivative + Riccati reverse sweep: writes k_, K_; returns the
        per-lane ok mask (0/1)."""
        lz_all, lzz_all, fz_all = D
        lfx, lfxx = term_grads()
        Vx = [lfx[i] for i in range(nx)]
        Vxx = [[lfxx[i, j] for j in range(nx)] for i in range(nx)]
        ok = one_
        for t in reversed(range(T)):
            lz = [lz_all[t, i] for i in range(nz)]
            lzz = [[lzz_all[t, i, j] for j in range(nz)] for i in range(nz)]
            fz = [[fz_all[t, i, j] for j in range(nz)] for i in range(nx)]
            eqv, eqz = eq_rows(t)
            pe = [mval[t, a] for a in range(e)]
            pex = [[mjac[t, a * nx + i] for i in range(nx)] for a in range(e)]
            tmp = [pe[a] + mu_ * eqv[a] for a in range(e)]
            tmp2 = [[pex[a][j] + mu_ * eqz[a][j] for j in range(nx)] for a in range(e)]
            Qz = []
            for i in range(nz):
                s = lz[i]
                for o in range(nx):
                    s = s + fz[o][i] * Vx[o]
                Qz.append(s)
            for a in range(e):
                for i in range(nx):
                    Qz[i] = Qz[i] + eqz[a][i] * tmp[a] + pex[a][i] * eqv[a]
                for i in range(m):
                    Qz[nx + i] = Qz[nx + i] + eqz[a][nx + i] * tmp[a]
            Vf = [
                [sum(Vxx[o][r] * fz[r][j] for r in range(nx)) for j in range(nz)]
                for o in range(nx)
            ]
            Qzz = [[None] * nz for _ in range(nz)]
            for i in range(nz):
                for j in range(nz):
                    s = lzz[i][j]
                    for o in range(nx):
                        s = s + fz[o][i] * Vf[o][j]
                    Qzz[i][j] = s
            for a in range(e):
                for i in range(nx):
                    for j in range(nx):
                        Qzz[i][j] = Qzz[i][j] + eqz[a][i] * tmp2[a][j] + pex[a][i] * eqz[a][j]
                    for i2 in range(m):
                        Qzz[nx + i2][i] = Qzz[nx + i2][i] + eqz[a][nx + i2] * tmp2[a][i]
                for i2 in range(m):
                    for j2 in range(m):
                        Qzz[nx + i2][nx + j2] = (
                            Qzz[nx + i2][nx + j2] + mu_ * eqz[a][nx + i2] * eqz[a][nx + j2]
                        )
            Quu = [
                [Qzz[nx + i][nx + j] + (reg_ if i == j else 0.0) for j in range(m)]
                for i in range(m)
            ]
            rhss = [[Qz[nx + i] for i in range(m)]] + [
                [Qzz[nx + i][jx] for i in range(m)] for jx in range(nx)
            ]
            sols, L = _chol_solve_rows(Quu, rhss, m)
            k_sol, K_cols = sols[0], sols[1:]
            for i in range(m):
                ok = ok * flag((L[i][i] > 0.0) & torch.isfinite(L[i][i]))
            for i in range(m):
                k_[t, i] = -k_sol[i]
                for jx in range(nx):
                    K_[t, i * nx + jx] = -K_cols[jx][i]
            Vx_new = []
            for i in range(nx):
                s = Qz[i]
                for o in range(m):
                    s = s - Qzz[nx + o][i] * k_sol[o]
                Vx_new.append(s)
            Vxx_new = [[None] * nx for _ in range(nx)]
            for i in range(nx):
                for j in range(nx):
                    s = Qzz[i][j]
                    for o in range(m):
                        s = s - Qzz[nx + o][i] * K_cols[j][o]
                    Vxx_new[i][j] = s
            Vx, Vxx = Vx_new, Vxx_new
        return ok

    def al_penalty(X, U, mu_):
        """p(x)·ce + (μ/2)‖ce‖² of the trajectory (X, U) at the active step."""
        if not constrained:
            return zero
        x, u = X[ta], U[ta]
        ce = eq_value(x, u)
        total = zero
        for a in range(e):
            cea = ce[a] * mrow[a]
            p = mval[ta, a]
            for i in range(nx):
                p = p + mjac[ta, a * nx + i] * (x[i] - morig[ta, i])
            total = total + p * cea + 0.5 * mu_ * cea * cea
        return total

    def incumbent_cost(mu_):
        c = zero
        for t in range(T):
            c = c + stage(xs[t], us[t])
        return c + term_cost(xs[T]) + al_penalty(xs, us, mu_)

    def rollout(step):
        """Roll (xc, uc) out at the per-lane step (feedback about xs/us with
        k_/K_); returns the stage-cost sum."""
        xc[0] = xs[0]
        acc = zero
        for t in range(T):
            x = xc[t]
            dx = [x[i] - xs[t, i] for i in range(nx)]
            for j in range(m):
                s = us[t, j] + step * k_[t, j]
                for i in range(nx):
                    s = s + K_[t, j * nx + i] * dx[i]
                uc[t, j] = s
            u = uc[t]
            xc[t + 1] = dyn(x, u)
            acc = acc + stage(x, u)
        return acc

    def linesearch(mu_, ok):
        """Returns (the step taken, keep): keep marks the ok lanes that
        accepted a candidate; their (xc, uc) holds the accepted rollout."""
        cost_old = incumbent_cost(mu_)
        chosen, taken = zero, zero
        for c in range(n_linesearch):
            step = zero + 2.0**-c
            cost_c = rollout(step) + term_cost(xc[T]) + al_penalty(xc, uc, mu_)
            acc = flag(cost_c - cost_old <= 0.0)
            newly = acc * (1.0 - taken)
            chosen = chosen + newly * 2.0**-c
            taken = torch.maximum(taken, acc)
        rollout(chosen)
        return chosen * taken, ok * taken

    def commit(keep):
        sel = keep > 0
        us.copy_(torch.where(sel, uc, us))
        xs[1:] = torch.where(sel, xc[1:], xs[1:])

    def commit_fb(ok):
        sel = ok > 0
        fbk.copy_(torch.where(sel, k_, fbk))
        fbK.copy_(torch.where(sel, K_, fbK))
        fborig.copy_(torch.where(sel, xs[:T], fborig))

    def update_origin(val, jac, origin, rows):
        d = xs[:T] - origin
        for a in range(rows):
            s = val[:, a]
            for i in range(nx):
                s = s + jac[:, a * nx + i] * d[:, i]
            val[:, a] = s
        origin.copy_(xs[:T])

    def opt_measures(D, mu_):
        """(opt_obj, opt_constr, opt_lag) by the reverse adjoint recursion."""
        lz_all, _, fz_all = D
        oc = zero
        if constrained:
            s = zero
            for a in range(e):
                va = eqr[a * (1 + nz)]
                s = s + va * va
            oc = torch.sqrt(s)
        lfx, _ = term_grads()
        a_o = [lfx[i] for i in range(nx)]
        a_l = [lfx[i] for i in range(nx)]
        oo, olag = zero, zero
        for t in reversed(range(T)):
            lz_a, fz_a = lz_all[t], fz_all[t]
            eqv, eqz = eq_rows(t)
            pe = [mval[t, a] for a in range(e)]
            pex = [[mjac[t, a * nx + i] for i in range(nx)] for a in range(e)]
            so, sl = zero, zero
            for i in range(m):
                vo = lz_a[nx + i]
                vel = lz_a[nx + i]
                for a in range(e):
                    vo = vo + eqz[a][nx + i] * (pe[a] + mu_ * eqv[a])
                    vel = vel + eqz[a][nx + i] * pe[a]
                for o in range(nx):
                    vo = vo + fz_a[o, nx + i] * a_o[o]
                    vel = vel + fz_a[o, nx + i] * a_l[o]
                so = so + vo * vo
                sl = sl + vel * vel
            oo = torch.maximum(oo, torch.sqrt(so))
            olag = torch.maximum(olag, torch.sqrt(sl))
            new_o, new_l = [], []
            for i in range(nx):
                ao = lz_a[i]
                for o in range(nx):
                    ao = ao + fz_a[o, i] * a_o[o]
                for a in range(e):
                    ao = ao + mu_ * eqz[a][i] * eqv[a] + eqz[a][i] * pe[a] + pex[a][i] * eqv[a]
                new_o.append(ao)
            for i in range(nx):
                al_ = lz_a[i]
                for o in range(nx):
                    al_ = al_ + fz_a[o, i] * a_l[o]
                for a in range(e):
                    al_ = al_ + eqz[a][i] * pe[a] + pex[a][i] * eqv[a]
                new_l.append(al_)
            a_o, a_l = new_o, new_l
        return oo, oc, olag

    # ---- pre-loop backward / forward ---------------------------------------
    hoist_eq()
    ok = backward(derivs_all(), mu, reg)
    _, keep = linesearch(mu, ok)
    commit(keep)
    commit_fb(ok)  # anchored at the trajectory after the line search
    reg = torch.where(ok > 0, reg, torch.maximum(reg, mu) * 2.0)

    # ---- iterations ----------------------------------------------------------
    for _ in range(params.max_iterations):
        hoist_eq()
        update_origin(mval, mjac, morig, e)
        update_origin(fbk, fbK, fborig, m)
        D = derivs_all()
        oo, oc, olag = opt_measures(D, mu)
        done = flag((olag < threshold) & (oc < threshold))
        plateau = flag(oo >= 0.1 * oo_prev) * (1.0 - just_changed)
        gate = torch.maximum(flag(oo < torch.clamp(w, min=w_min)), plateau)
        if params.inner_iters_max is not None:
            gate = torch.maximum(gate, flag(inner >= float(params.inner_iters_max)))
        upd_s = (1.0 - done) * gate * flag(oc < n_tol)
        upd_f = (1.0 - done) * gate * flag(oc >= n_tol)

        if constrained:
            for a in range(e):
                eqv_a = eqr[a * (1 + nz)]
                fb_term = zero
                if not primal:
                    for j in range(m):
                        fb_term = fb_term + eqr[a * (1 + nz) + 1 + nx + j] * fbk[ta, j]
                v_new = mval[ta, a] + mu * (eqv_a + fb_term)
                if params.mult_max is not None:
                    v_new = torch.clamp(v_new, -params.mult_max, params.mult_max)
                mval[ta, a] = torch.where(upd_s > 0, v_new, mval[ta, a])
                if affine:
                    for i in range(nx):
                        fbj = zero
                        if not primal:
                            for j in range(m):
                                fbj = fbj + eqr[a * (1 + nz) + 1 + nx + j] * fbK[ta, j * nx + i]
                        j_new = mjac[ta, a * nx + i] + mu * (eqr[a * (1 + nz) + 1 + i] + fbj)
                        if params.mult_max is not None:
                            j_new = torch.clamp(j_new, -params.mult_max, params.mult_max)
                        mjac[ta, a * nx + i] = torch.where(upd_s > 0, j_new, mjac[ta, a * nx + i])
        mu_new = torch.where(upd_f > 0, mu * sc["mu_factor"], mu)
        if params.mu_max is not None:
            mu_new = torch.clamp(mu_new, max=float(params.mu_max))
        n_tol = torch.where(
            upd_s > 0,
            torch.clamp(n_tol * mu**-0.9, min=threshold),
            torch.where(upd_f > 0, mu_new**-0.1, n_tol),
        )
        w = torch.where(upd_s > 0, w / mu, w)

        ok = backward(D, mu_new, reg)
        step, keep = linesearch(mu_new, ok)
        reg = torch.where(
            ok > 0,
            torch.where(step >= 0.5, torch.where(reg / 2 < 1e-5, zero, reg / 2), reg),
            torch.maximum(reg, mu_new) * 2.0,
        )
        commit_fb(ok)  # anchored at the trajectory the gains were computed about
        commit(keep)
        mu = mu_new
        oo_prev = oo
        just_changed = torch.maximum(upd_s, upd_f)
        inner = torch.where(just_changed > 0, one_, inner + 1.0)

    # ---- final measures --------------------------------------------------------
    hoist_eq()
    update_origin(mval, mjac, morig, e)
    _, oc, olag = opt_measures(derivs_all(), mu)
    stats = torch.stack([oc, olag, mu, reg, w, n_tol])
    return _result(us, xs, fbk, fbK, stats, mval, mjac, T, m, e, nx)


def _result(us, xs, fbk, fbK, stats, mval, mjac, T, m, e, nx):
    """The kernel's batch-last outputs as a batch-major ``BatchSolveResult``."""
    B = us.shape[-1]
    xs_b = xs.permute(2, 0, 1)
    if e:
        val = mval.permute(2, 0, 1)
        jac = mjac.reshape(T, e, nx, B).permute(3, 0, 1, 2)
    else:
        val = xs.new_zeros((B, T, 0))
        jac = xs.new_zeros((B, T, 0, nx))
    return BatchSolveResult(
        xs=xs_b, us=us.permute(2, 0, 1), fb_k=fbk.permute(2, 0, 1),
        fb_K=fbK.reshape(T, m, nx, B).permute(3, 0, 1, 2),
        opt_constr=stats[0], opt_lag=stats[1], mu=stats[2],
        mults=al_mod.AffineMults(val=val, jac=jac, origin=xs_b[:, :-1]),
        reg=stats[3], w=stats[4], n=stats[5],
    )  # fmt: skip


def solve_flat(
    problem,
    params,
    x0s,  # [B, nx]
    us_init=None,  # [B, T, m]
    method=None,  # default Method.PRIMAL_DUAL_AFFINE
    n_linesearch: int = 8,
):
    """One-launch whole solve for a flat-lane problem: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns a ``BatchSolveResult``
    matching ``solve_batched(..., n_reg_levels=1, n_linesearch=n_linesearch)``.

    Raises ``ValueError`` for a second-order problem, a model that is not a
    vector space, nx != ndx, more than one active constraint step, and a
    problem outside the flat-lane class
    (``kernels/flat_problem.py``)."""
    if n_linesearch < 1:
        raise ValueError(f"n_linesearch must be >= 1, got {n_linesearch}")
    if x0s.device.type == "cpu":
        pack_problem(problem)  # the class gate holds on the CPU too
        return solve_flat_reference(problem, params, x0s, us_init, method, n_linesearch)
    return launch_plan(plan_launch(problem, params, x0s, us_init, method, n_linesearch))


class LaunchPlan(NamedTuple):
    """One launch of the whole-solve kernel, ready to go: the device tensors
    (inputs, outputs that double as working storage, scratch) and the host
    arguments.  A plan can be launched again: the kernel initialises
    everything it reads.  Each launch fills ``geometry`` with the kernel's
    own launch plan: threads a lane, lanes a block and shared-memory bytes a
    block."""

    tensors: list  # x0, us0, scal, consts, mrow, 7 outputs
    ints: list
    reals: list
    flat: FlatProblem
    dims: tuple  # (T, nx, m, e)
    geometry: dict


def plan_launch(problem, params, x0s, us_init=None, method=None, n_linesearch=8) -> LaunchPlan:
    """Check the arguments against the gates, the problem's flat-lane class and
    the kernel's instantiations, and allocate what one launch needs."""
    method, T, m, e, ta, mrow, us_init, sc = _setup(problem, params, x0s, us_init, method)
    flat = pack_problem(problem)
    B, nx = x0s.shape
    dtype, dev = x0s.dtype, x0s.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    if not 1 <= n_linesearch <= 31:
        raise ValueError(f"the kernel takes 1 to 31 candidates, got {n_linesearch}")
    if tuple(us_init.shape) != (B, T, m) or us_init.dtype != dtype or us_init.device != dev:
        raise ValueError(
            f"us_init: {us_init.dtype} {tuple(us_init.shape)} on {us_init.device}, "
            f"expected {dtype} {(B, T, m)} on {dev}"
        )
    kw = dict(dtype=dtype, device=dev)

    def empty(*shape):
        return torch.empty(shape, **kw)

    x0 = x0s.T.contiguous()
    us0 = us_init.permute(1, 2, 0).contiguous()
    scal = torch.tensor([params.mu, params.reg, sc["w0"], sc["n0"]], **kw)[:, None].repeat(1, B)
    mrow_t = torch.tensor(mrow, **kw)
    e_k = max(e, 1)
    # outputs, [T, rows, B] so that neighbouring threads touch neighbouring
    # addresses (the kernel works in shared memory)
    outs = [empty(T, m, B), empty(T + 1, nx, B), empty(T, m, B), empty(T, m * nx, B),
            empty(6, B), empty(T, e_k, B), empty(T, e_k * nx, B)]  # fmt: skip
    ints = [
        T, B, params.max_iterations, n_linesearch, ta,
        int(method is Method.PRIMAL_DUAL_AFFINE), int(method is Method.PRIMAL),
        int(params.mu_max is not None), int(params.mult_max is not None),
        -1 if params.inner_iters_max is None else int(params.inner_iters_max),
    ]  # fmt: skip
    reals = [
        sc["threshold"], sc["w_min"], sc["mu_factor"],
        float(params.mu_max) if params.mu_max is not None else 0.0,
        float(params.mult_max) if params.mult_max is not None else 0.0,
    ]  # fmt: skip
    return LaunchPlan(
        tensors=[x0, us0, scal, flat.consts, mrow_t] + outs, ints=ints, reals=reals,
        flat=flat, dims=(T, nx, m, e), geometry={},
    )  # fmt: skip


def launch_plan(plan: LaunchPlan) -> BatchSolveResult:
    """Launch the kernel once on ``plan``; the result's tensors are views of
    the plan's output buffers."""
    global LAUNCHES
    T, nx, m, e = plan.dims
    x0 = plan.tensors[0]
    ptrs = (ctypes.c_void_p * len(plan.tensors))(*[x.data_ptr() for x in plan.tensors])
    fn = _kernel_fn(plan.flat.build)
    geometry = (ctypes.c_int * 3)()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = fn(
            int(x0.dtype == torch.float64), plan.flat.dynamics, plan.flat.cost, e,
            ctypes.cast(ptrs, ctypes.c_void_p),
            (ctypes.c_int * len(plan.ints))(*plan.ints),
            (ctypes.c_double * len(plan.reals))(*plan.reals),
            ctypes.cast(geometry, ctypes.c_void_p), stream,
        )  # fmt: skip
    if rc == -1:  # the only gate plan_launch cannot check: the shared memory
        raise ValueError(_NO_FIT.format(T=T, e=e))
    if rc == -2:
        raise RuntimeError(f"flat_solve: the library does not serve the class {plan.flat.build}")
    if rc != 0:
        raise RuntimeError(f"flat_solve kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    plan.geometry.update(threads_per_lane=geometry[0], lanes_per_block=geometry[1],
                         smem_bytes=geometry[2])  # fmt: skip
    us, xs, fbk, fbK, stats, mval, mjac = plan.tensors[5:12]
    return _result(us, xs, fbk, fbK, stats, mval, mjac, T, m, e, nx)


def _kernel_fn(build: dict):
    """The kernel of the library built for a class's ``FlatProblem.build``
    constants (prebuilt with ``_kernel_fn({"DYN": 0, "COST": 0, "E": 1})``)."""
    lib = _build.load(SOURCE, build)
    fn = lib.ddp_flat_solve
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn
