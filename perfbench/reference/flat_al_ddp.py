"""Plain PyTorch reference of the flat-lane AL-DDP solve, frozen with the
benchmark: the fixed-budget augmented-Lagrangian DDP recipe that
``ddp_tpu_torch.kernels.flat_solve.solve_flat`` runs, written again from its
definition and built from a configuration file alone.  It imports nothing of
the program.

The recipe (per lane, lanes independent):

- the pendulum a = -(g/l)·sin q + u/m, explicit Euler
  (q', v') = (q + dt·v, v + dt·a), stage cost ½·c·u², no terminal cost;
- one equality constraint active at one step ta: a configuration target
  (q - q*) or a state target (q - q*, v - v*) reached ``advance_times``
  steps after ta through the same dynamics with the same u;
- Gauss-Newton DDP, one regularisation level, ``n_linesearch`` candidate
  steps 2^-c (the largest that lowers the augmented cost is taken), affine
  multipliers p(x) = val + jac·(x - origin) re-anchored every iteration,
  feedback gains re-anchored likewise, and the multiplier / μ / w / n / reg
  schedule with the μ and multiplier caps where the configuration sets
  them;
- the stopping measures: opt_constr = ‖eq‖ at ta, opt_lag the largest
  control gradient of the Lagrangian by the reverse adjoint recursion.

Everything is batched over lanes ([B, ...] tensors) and computed in the
``dtype`` asked for: float64 for the comparison, a lower precision for the
control.  Constants that the configuration derives from its own type (w_min)
come from the configuration's type, not from ``dtype``.
"""

from __future__ import annotations

import math

import torch

GRAVITY = 9.81
TYPES = {"float32": torch.float32, "float64": torch.float64}


class Recipe:
    """The numbers of one configuration file that the solve needs."""

    def __init__(self, cfg: dict):
        if cfg.get("discretization", "euler") != "euler":
            raise ValueError("the reference integrates with explicit Euler only")
        cost = cfg["cost"]
        if cost["kind"] != "quad_control":
            raise ValueError("the reference takes the control cost ½·c·‖u‖² only")
        con = cfg["constraint"]
        if con["kind"] not in ("config", "state"):
            raise ValueError(f"the reference takes config and state targets, not {con['kind']!r}")
        if cfg.get("second_order"):
            raise ValueError("the reference is Gauss-Newton only")
        self.mass, self.length, self.dt = float(cfg["mass"]), float(cfg["length"]), float(cfg["dt"])
        self.c = float(cost["c"])
        self.T = int(cfg["horizon"])
        self.target = [float(v) for v in con["target"]]
        self.kind = con["kind"]
        self.e = 1 if self.kind == "config" else 2
        if len(self.target) != self.e:
            raise ValueError(f"a {self.kind} target has {self.e} values, got {self.target}")
        self.layers = int(con.get("advance_times", 0))
        (active,) = con["active_ts"]
        self.ta = int(active) - self.layers
        if not 0 <= self.ta < self.T:
            raise ValueError(f"the active step {self.ta} lies outside the horizon {self.T}")
        self.max_iterations = int(cfg["max_iterations"])
        self.threshold = float(cfg["threshold"])
        self.mu0 = float(cfg["mu"])
        self.reg0 = float(cfg.get("reg", 0.0))
        self.mu_factor = float(cfg.get("mu_factor", 10.0))
        self.mu_max = cfg.get("mu_max")
        self.mult_max = cfg.get("mult_max")
        self.inner_iters_max = cfg.get("inner_iters_max")
        self.n_linesearch = int(cfg["n_linesearch"])
        if cfg.get("method", "primal_dual_affine_multipliers") != "primal_dual_affine_multipliers":
            raise ValueError("the reference runs the affine-multiplier method only")
        eps = torch.finfo(TYPES[cfg["dtype"]]).eps
        self.w_min = float(cfg.get("w_min") or 10.0 * math.sqrt(eps))
        self.w0 = float(cfg.get("w") or 1.0 / self.mu0)
        self.n0 = float(cfg.get("n") or 1.0 / self.mu0**0.1)


def dynamics(r: Recipe, x, u):
    """x [..., 2], u [..., 1] → the next state."""
    q, v = x[..., 0], x[..., 1]
    a = -(GRAVITY / r.length) * torch.sin(q) + u[..., 0] / r.mass
    return torch.stack([q + r.dt * v, v + r.dt * a], dim=-1)


def jacobians(r: Recipe, x):
    """(fx [..., 2, 2], fu [..., 2, 1]) of the step at x (they do not depend
    on u)."""
    q = x[..., 0]
    one = torch.ones_like(q)
    zero = torch.zeros_like(q)
    fx = torch.stack(
        [torch.stack([one, zero + r.dt], -1),
         torch.stack([r.dt * (-(GRAVITY / r.length) * torch.cos(q)), one], -1)], -2,
    )  # fmt: skip
    fu = torch.stack([zero, zero + r.dt / r.mass], -1)[..., None]
    return fx, fu


def constraint(r: Recipe, x, u, with_jacobian=False):
    """eq [..., e] of the state reached ``layers`` steps after (x, u) with u
    held, and with ``with_jacobian`` its (eq_x [..., e, 2], eq_u [..., e, 1])."""
    y = x
    jx = jx_u = None
    if with_jacobian:
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        jx = eye.expand(x.shape[:-1] + (2, 2))
        jx_u = torch.zeros(x.shape[:-1] + (2, 1), dtype=x.dtype, device=x.device)
    for _ in range(r.layers):
        if with_jacobian:
            fx, fu = jacobians(r, y)
            jx, jx_u = fx @ jx, fx @ jx_u + fu
        y = dynamics(r, y, u)
    tgt = torch.tensor(r.target, dtype=x.dtype, device=x.device)
    eq = y[..., : r.e] - tgt
    if not with_jacobian:
        return eq
    return eq, jx[..., : r.e, :], jx_u[..., : r.e, :]


def rollout(r: Recipe, x0, us):
    """xs [B, T + 1, 2] of the controls us [B, T, 1] from x0 [B, 2]."""
    xs = [x0]
    for t in range(r.T):
        xs.append(dynamics(r, xs[-1], us[:, t]))
    return torch.stack(xs, dim=1)


def solve(cfg: dict, x0s: torch.Tensor, dtype: torch.dtype = torch.float64) -> dict:
    """The recipe's solve of every lane of x0s [B, 2] in ``dtype``, on x0s's
    device.  Returns the fields ``solve_flat`` returns, batch-major: us, xs,
    fb_k, fb_K, mult_val, mult_jac, mult_origin, and per lane opt_constr,
    opt_lag, mu, reg, w, n."""
    r = Recipe(cfg)
    x0 = x0s.to(dtype)
    B, T, ta, e, S = x0.shape[0], r.T, r.ta, r.e, r.n_linesearch
    kw = dict(dtype=dtype, device=x0.device)

    def full(value):
        return torch.full((B,), value, **kw)

    us = torch.zeros((B, T, 1), **kw)
    xs = rollout(r, x0, us)
    # the multipliers live at the active step alone (zero elsewhere)
    mval = torch.zeros((B, e), **kw)
    mjac = torch.zeros((B, e, 2), **kw)
    morig = xs[:, ta].clone()
    fbk = torch.zeros((B, T, 1), **kw)
    fbK = torch.zeros((B, T, 1, 2), **kw)
    fborig = xs[:, :T].clone()
    mu, reg = full(r.mu0), full(r.reg0)
    w, n_tol = full(r.w0), full(r.n0)
    oo_prev = full(math.inf)
    just_changed = torch.ones(B, dtype=torch.bool, device=x0.device)
    inner = full(1.0)
    eq_hoist = None  # (ev, ex, eu) at ta on the current trajectory

    def hoist():
        return constraint(r, xs[:, ta], us[:, ta], with_jacobian=True)

    def derivatives():
        fx, fu = jacobians(r, xs[:, :T])
        return fx, fu, r.c * us  # lu; luu = c, every other cost term 0

    def penalty(x_ta, u_ta, mu_):
        ce = constraint(r, x_ta, u_ta)
        p = mval + (mjac @ (x_ta - morig)[..., None])[..., 0]
        return (p * ce + 0.5 * mu_[..., None] * ce * ce).sum(-1)

    def backward(D, mu_, reg_):
        """(k [B, T, 1], K [B, T, 1, 2], ok [B]) of the Riccati sweep."""
        fx_all, fu_all, lu_all = D
        ev, ex, eu = eq_hoist
        Vx = torch.zeros((B, 2, 1), **kw)
        Vxx = torch.zeros((B, 2, 2), **kw)
        ok = torch.ones(B, dtype=torch.bool, device=x0.device)
        k = torch.empty((B, T, 1), **kw)
        K = torch.empty((B, T, 1, 2), **kw)
        mu_c = mu_[:, None, None]
        for t in reversed(range(T)):
            A, Bu = fx_all[:, t], fu_all[:, t]
            At, Bt = A.transpose(-1, -2), Bu.transpose(-1, -2)
            Qx = At @ Vx
            Qu = lu_all[:, t, :, None] + Bt @ Vx
            VA, VB = Vxx @ A, Vxx @ Bu
            Qxx, Qux, Quu = At @ VA, Bt @ VA, r.c + Bt @ VB
            if t == ta:
                exT, euT = ex.transpose(-1, -2), eu.transpose(-1, -2)
                pex = mjac
                tmp = mval[..., None] + mu_c * ev[..., None]  # [B, e, 1]
                tmp2 = pex + mu_c * ex  # [B, e, 2]
                Qx = Qx + exT @ tmp + pex.transpose(-1, -2) @ ev[..., None]
                Qu = Qu + euT @ tmp
                Qxx = Qxx + exT @ tmp2 + pex.transpose(-1, -2) @ ex
                Qux = Qux + euT @ tmp2
                Quu = Quu + mu_c * (euT @ eu)
            Quu = Quu + reg_[:, None, None]
            pivot = torch.sqrt(Quu[:, 0, 0])  # m = 1: the Cholesky factor
            ok = ok & (pivot > 0) & torch.isfinite(pivot)
            k_t = -Qu / Quu
            K_t = -Qux / Quu
            k[:, t], K[:, t] = k_t[..., 0], K_t
            Vx = Qx + Qux.transpose(-1, -2) @ k_t
            Vxx = Qxx + Qux.transpose(-1, -2) @ K_t
        return k, K, ok

    def linesearch(k, K, mu_, ok):
        """(step [B], keep [B], xc, uc): the candidates 2^-c rolled out side
        by side, the largest whose augmented cost is no higher than the
        incumbent's taken; keep marks ok lanes that took one."""
        cost_old = 0.5 * r.c * (us * us).sum((1, 2)) + penalty(xs[:, ta], us[:, ta], mu_)
        steps = torch.tensor([2.0**-c for c in range(S)], **kw)[:, None, None]  # [S, 1, 1]
        x = x0.expand(S, B, 2)
        xc, uc = [x], []
        for t in range(T):
            dx = x - xs[:, t]
            u = us[:, t] + steps * k[:, t] + (K[:, t] @ dx[..., None])[..., 0]
            uc.append(u)
            x = dynamics(r, x, u)
            xc.append(x)
        xc, uc = torch.stack(xc, 2), torch.stack(uc, 2)  # [S, B, T (+1), ·]
        cost = 0.5 * r.c * (uc * uc).sum((2, 3)) + penalty(xc[:, :, ta], uc[:, :, ta], mu_)
        acc = cost - cost_old <= 0  # [S, B]
        taken = acc.any(0)
        first = torch.argmax(acc.to(torch.int8), 0)  # the first accepted candidate
        step = torch.where(taken, torch.pow(0.5, first.to(dtype)), torch.zeros((), **kw))
        pick = first[None, :, None, None]
        xsel = torch.take_along_dim(xc, pick, 0)[0]
        usel = torch.take_along_dim(uc, pick, 0)[0]
        return step, ok & taken, xsel, usel

    def measures(D, mu_):
        """(opt_obj, opt_constr, opt_lag) by the reverse adjoint recursion."""
        fx_all, fu_all, lu_all = D
        ev, ex, eu = eq_hoist
        oc = torch.sqrt((ev * ev).sum(-1))
        a_o = torch.zeros((B, 2, 1), **kw)
        a_l = torch.zeros((B, 2, 1), **kw)
        oo = torch.zeros(B, **kw)
        olag = torch.zeros(B, **kw)
        mu_c = mu_[:, None, None]
        for t in reversed(range(T)):
            At = fx_all[:, t].transpose(-1, -2)
            Bt = fu_all[:, t].transpose(-1, -2)
            vo = lu_all[:, t, :, None] + Bt @ a_o
            vl = lu_all[:, t, :, None] + Bt @ a_l
            new_o, new_l = At @ a_o, At @ a_l
            if t == ta:
                euT, exT = eu.transpose(-1, -2), ex.transpose(-1, -2)
                pe, pex = mval[..., None], mjac
                vo = vo + euT @ (pe + mu_c * ev[..., None])
                vl = vl + euT @ pe
                new_o = new_o + exT @ (mu_c * ev[..., None] + pe) + pex.transpose(-1, -2) @ ev[..., None]
                new_l = new_l + exT @ pe + pex.transpose(-1, -2) @ ev[..., None]
            oo = torch.maximum(oo, torch.linalg.vector_norm(vo[..., 0], dim=-1))
            olag = torch.maximum(olag, torch.linalg.vector_norm(vl[..., 0], dim=-1))
            a_o, a_l = new_o, new_l
        return oo, oc, olag

    def reanchor_fb():
        nonlocal fbk, fborig
        fbk = fbk + (fbK @ (xs[:, :T] - fborig)[..., None])[..., 0]
        fborig = xs[:, :T].clone()

    def reanchor_mults():
        nonlocal mval, morig
        mval = mval + (mjac @ (xs[:, ta] - morig)[..., None])[..., 0]
        morig = xs[:, ta].clone()

    def commit_fb(k, K, ok):
        nonlocal fbk, fbK, fborig
        sel = ok[:, None, None]
        fbk = torch.where(sel, k, fbk)
        fbK = torch.where(sel[..., None], K, fbK)
        fborig = torch.where(sel, xs[:, :T], fborig)

    def commit(keep, xc, uc):
        nonlocal xs, us
        sel = keep[:, None, None]
        us = torch.where(sel, uc, us)
        xs = torch.where(sel, xc, xs)

    # the first pass
    eq_hoist = hoist()
    D = derivatives()
    k, K, ok = backward(D, mu, reg)
    _, keep, xc, uc = linesearch(k, K, mu, ok)
    commit(keep, xc, uc)
    commit_fb(k, K, ok)  # anchored at the trajectory after the line search
    reg = torch.where(ok, reg, torch.maximum(reg, mu) * 2.0)

    for _ in range(r.max_iterations):
        eq_hoist = hoist()
        reanchor_mults()
        reanchor_fb()
        D = derivatives()
        oo, oc, olag = measures(D, mu)
        done = (olag < r.threshold) & (oc < r.threshold)
        plateau = (oo >= 0.1 * oo_prev) & ~just_changed
        gate = (oo < torch.clamp(w, min=r.w_min)) | plateau
        if r.inner_iters_max is not None:
            gate = gate | (inner >= float(r.inner_iters_max))
        upd_s = ~done & gate & (oc < n_tol)
        upd_f = ~done & gate & (oc >= n_tol)
        ev, ex, eu = eq_hoist
        mu_c = mu[:, None]
        v_new = mval + mu_c * (ev + (eu @ fbk[:, ta, :, None])[..., 0])
        j_new = mjac + mu_c[..., None] * (ex + eu @ fbK[:, ta])
        if r.mult_max is not None:
            v_new = torch.clamp(v_new, -r.mult_max, r.mult_max)
            j_new = torch.clamp(j_new, -r.mult_max, r.mult_max)
        mval = torch.where(upd_s[:, None], v_new, mval)
        mjac = torch.where(upd_s[:, None, None], j_new, mjac)
        mu_new = torch.where(upd_f, mu * r.mu_factor, mu)
        if r.mu_max is not None:
            mu_new = torch.clamp(mu_new, max=float(r.mu_max))
        n_tol = torch.where(
            upd_s,
            torch.clamp(n_tol * mu**-0.9, min=r.threshold),
            torch.where(upd_f, mu_new**-0.1, n_tol),
        )
        w = torch.where(upd_s, w / mu, w)

        k, K, ok = backward(D, mu_new, reg)
        step, keep, xc, uc = linesearch(k, K, mu_new, ok)
        halved = torch.where(reg / 2 < 1e-5, torch.zeros((), **kw), reg / 2)
        reg = torch.where(ok, torch.where(step >= 0.5, halved, reg), torch.maximum(reg, mu_new) * 2.0)
        commit_fb(k, K, ok)  # anchored at the trajectory the gains were computed about
        commit(keep, xc, uc)
        mu = mu_new
        oo_prev = oo
        just_changed = upd_s | upd_f
        inner = torch.where(just_changed, torch.ones((), **kw), inner + 1.0)

    eq_hoist = hoist()
    reanchor_mults()
    _, oc, olag = measures(derivatives(), mu)
    mult_val = torch.zeros((B, T, e), **kw)
    mult_jac = torch.zeros((B, T, e, 2), **kw)
    mult_val[:, ta], mult_jac[:, ta] = mval, mjac
    return dict(
        us=us, xs=xs, fb_k=fbk, fb_K=fbK, mult_val=mult_val, mult_jac=mult_jac,
        mult_origin=xs[:, :T], opt_constr=oc, opt_lag=olag, mu=mu, reg=reg, w=w, n=n_tol,
    )  # fmt: skip
