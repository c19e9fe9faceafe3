"""Throughput-mode batched AL-DDP with static control flow
(≙ ddp_tpu/solver/batched.py).

- outer loop: a fixed iteration count for every lane;
- line search: a parallel sweep over step candidates (1, ½, ¼, …), one
  batched rollout for all candidates; each lane takes the largest step whose
  AL cost did not rise and keeps its trajectory if none did;
- Cholesky failure: per-lane reg escalation for the next iteration, or a
  parallel ladder of reg levels within one backward pass;
- AL schedule: masked elementwise updates, every lane carries its own
  (μ, reg, w, n) state.

The batch is the leading dim of every tensor; the backward pass is either a
batched PyTorch sweep (``backward="sweep"``) or the Riccati kernel over the
whole batch (``backward="kernel"``, ``kernels/riccati_small.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ddp_tpu_torch.kernels.riccati_small import backward_sweep, pack_batch_last
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.riccati import factor_solve
from ddp_tpu_torch.solver.rollout import feedback_rollout
from ddp_tpu_torch.solver.solve import Method, SolverParams


class BatchSolveResult(NamedTuple):
    xs: torch.Tensor  # [B, T+1, nx]
    us: torch.Tensor  # [B, T, nu]
    fb_k: torch.Tensor  # [B, T, nu]
    fb_K: torch.Tensor  # [B, T, nu, ndx]
    opt_constr: torch.Tensor  # [B]
    opt_lag: torch.Tensor  # [B]
    mu: torch.Tensor  # [B]
    mults: al_mod.AffineMults  # [B, T, ...], re-anchored at xs
    reg: torch.Tensor  # [B]
    w: torch.Tensor  # [B] inner-convergence gate tolerance
    n: torch.Tensor  # [B] constraint-progress gate tolerance


def _reg_levels(mu, reg, n_levels):
    """The regularization ladder [reg, 2·max(reg,μ), 32·max(reg,μ), …]
    (each [B]); shared by both backward backends."""
    base = torch.maximum(reg, mu) * 2.0
    return [reg] + [base * 16.0**i for i in range(n_levels - 1)]


def _backward_sweep(derivs, mult_val, mult_jac, mu, reg):
    """One batched Riccati sweep (no retry): returns (k [B,T,nu],
    K [B,T,nu,ndx], ok [B])."""

    tmv = al_mod.tmv

    def contract(v, H):  # einsum("o,oij->ij") per lane
        return torch.einsum("bo,boij->bij", v, H)

    d = derivs
    T, nu = d.lu.shape[1], d.lu.shape[2]
    I_u = torch.eye(nu, dtype=d.lx.dtype, device=d.lx.device)
    mu1, mu2 = mu[:, None], mu[:, None, None]
    Vx, Vxx = d.lfx, d.lfxx
    ks, Ks = [None] * T, [None] * T
    ok = torch.ones(mu.shape, dtype=torch.bool, device=mu.device)
    for t in reversed(range(T)):
        fx, fu, eqv, eqx, equ = d.fx[:, t], d.fu[:, t], d.eq[:, t], d.eqx[:, t], d.equ[:, t]
        pe, pex = mult_val[:, t], mult_jac[:, t]
        tmp = pe + mu1 * eqv
        tmp2 = pex + mu2 * eqx
        Qx = d.lx[:, t] + tmv(fx, Vx) + tmv(eqx, tmp) + tmv(pex, eqv)
        Qu = d.lu[:, t] + tmv(fu, Vx) + tmv(equ, tmp)
        Qxx = (
            d.lxx[:, t] + fx.mT @ Vxx @ fx + eqx.mT @ tmp2 + pex.mT @ eqx
            + contract(tmp, d.eqxx[:, t]) + contract(Vx, d.fxx[:, t])
        )  # fmt: skip
        Quu = (
            d.luu[:, t] + fu.mT @ Vxx @ fu + mu2 * equ.mT @ equ
            + contract(tmp, d.equu[:, t]) + contract(Vx, d.fuu[:, t])
        )  # fmt: skip
        Qux = (
            d.lux[:, t] + fu.mT @ Vxx @ fx + equ.mT @ tmp2
            + contract(tmp, d.equx[:, t]) + contract(Vx, d.fux[:, t])
        )  # fmt: skip
        ok_t, k, K = factor_solve(Quu + reg[:, None, None] * I_u, Qu, Qux)
        Vx = Qx + tmv(Qux, k)
        Vxx = Qxx + Qux.mT @ K
        ks[t], Ks[t] = k, K
        ok = ok & ok_t
    return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), ok


def _backward_multi_reg(derivs, mult_val, mult_jac, mu, reg, n_levels):
    """Run the sweep at every reg level of the ladder in one batch and keep,
    per lane, the smallest level that factorizes everywhere.  Returns
    (k, K, ok, reg_used); a lane with no good level keeps level 0."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))  # [L, B]
    L, B = levels.shape

    def rep(x):
        return x.repeat((L,) + (1,) * (x.dim() - 1))

    ks, Ks, oks = _backward_sweep(
        type(derivs)(*map(rep, derivs)), rep(mult_val), rep(mult_jac),
        rep(mu), levels.reshape(L * B),
    )  # fmt: skip
    oks = oks.reshape(L, B)
    idx = torch.argmax(oks.to(torch.int32), dim=0)  # first successful level
    lane = torch.arange(B, device=mu.device)
    ks = ks.reshape((L, B) + ks.shape[1:])[idx, lane]
    Ks = Ks.reshape((L, B) + Ks.shape[1:])[idx, lane]
    return ks, Ks, oks.any(dim=0), levels[idx, lane]


def _backward_kernel_levels(derivs, mult_val, mult_jac, mu, reg, n_levels):
    """The Riccati kernel over the whole batch, one launch per reg level,
    keeping per lane the first level that factorized.  Returns batch-major
    (k [B,T,m], K [B,T,m,n], ok [B], reg_used [B])."""
    B, T = derivs.lx.shape[0], derivs.lx.shape[1]
    n, m, e = derivs.lx.shape[-1], derivs.lu.shape[-1], derivs.eq.shape[-1]
    packed = pack_batch_last(derivs, mult_val, mult_jac)
    k = K = None
    ok_acc = torch.zeros(B, dtype=torch.bool, device=mu.device)
    reg_used = reg
    for lvl in _reg_levels(mu, reg, n_levels):
        k_i, K_i, ok_i = backward_sweep(packed, mu, lvl, T=T, n=n, m=m, e=e)
        newly = ~ok_acc & ok_i
        if k is None:
            k, K = k_i, K_i
        else:
            k = torch.where(newly, k_i, k)
            K = torch.where(newly, K_i, K)
        reg_used = torch.where(newly, lvl, reg_used)
        ok_acc = ok_acc | ok_i
    # kernel layout [T, m, B] / [T, m*n, B] → batch-major
    return (
        k.permute(2, 0, 1),
        K.reshape(T, m, n, B).permute(3, 0, 1, 2),
        ok_acc,
        reg_used,
    )


def _linesearch_sweep(problem, xs, us, k, K, mults, mu, n_candidates):
    """Parallel line search: roll out every candidate step in one batch
    [S, B, …], take per lane the largest step whose AL cost did not rise,
    keep the incumbent where none did.  Returns (xs, us, step [B])."""
    S, B = n_candidates, xs.shape[0]
    steps = torch.tensor(
        [2.0**-i for i in range(S)], dtype=xs.dtype, device=xs.device
    )  # 1, ½, ¼, …

    def ex(x):
        return x.expand((S,) + x.shape)

    cost_old = al_mod.al_costs(problem, xs, us, mults, mu).sum(dim=-1)
    xs_c, us_c = feedback_rollout(
        problem, ex(xs), ex(us), ex(k), ex(K), steps[:, None, None]
    )
    cost_c = al_mod.al_costs(
        problem, xs_c, us_c, al_mod.AffineMults(*map(ex, mults)), ex(mu)
    ).sum(dim=-1)  # [S, B]
    accepted = cost_c - cost_old <= 0
    idx = torch.argmax(accepted.to(torch.int32), dim=0)  # first = largest step
    any_acc = accepted.any(dim=0)
    lane = torch.arange(B, device=xs.device)
    xs_new = _bwhere(any_acc, xs_c[idx, lane], xs)
    us_new = _bwhere(any_acc, us_c[idx, lane], us)
    step = torch.where(any_acc, steps[idx], torch.zeros_like(steps[idx]))
    return xs_new, us_new, step


def _bwhere(c, a, b):
    """torch.where with the [B] condition broadcast against trailing dims."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


def _check_backends(backward, forward, deriv):
    deferred = {
        ("backward", "assoc"): "ROADMAP slice H",
        ("backward", "tf"): "ROADMAP slice G",
        ("forward", "seq"): "ROADMAP slice A, item 5",
        ("forward", "pallas"): "ROADMAP Queue 2, kernel 4 (linesearch_flat)",
        ("deriv", "pallas"): "ROADMAP slice B, item 8 (Queue 2, kernel 2)",
    }
    supported = {"backward": ("sweep", "kernel"), "forward": ("sweep",), "deriv": ("jvp",)}
    for knob, value in (("backward", backward), ("forward", forward), ("deriv", deriv)):
        if (knob, value) in deferred:
            raise NotImplementedError(
                f"{knob}={value!r} is still to be ported ({deferred[knob, value]})"
            )
        if value not in supported[knob]:
            raise ValueError(f"unknown {knob} backend {value!r}; have {supported[knob]}")


def solve_batched(
    problem,
    params: SolverParams,
    x0s: torch.Tensor,  # [B, nx]
    us_init: torch.Tensor | None = None,  # [B, T, nu]
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    n_linesearch: int | None = None,  # default 8 candidates (1 … 1/128)
    backward: str = "sweep",
    # "sweep": batched PyTorch Riccati sweep with the parallel reg ladder
    # "kernel": the Riccati kernel (kernels/riccati_small.py), one launch per
    #   reg level over the whole batch
    forward: str = "sweep",
    deriv: str = "jvp",
    n_reg_levels: int = 4,  # parallel regularization ladder depth (≥1)
) -> BatchSolveResult:
    """Fixed-budget batched AL-DDP: exactly ``params.max_iterations`` outer
    iterations for every lane (converged lanes no-op through the line search
    keeping their trajectory).  The problem's buffers and ``x0s`` must share
    one device and dtype."""
    _check_backends(backward, forward, deriv)
    T, nu = problem.horizon, problem.nu
    model = problem.model
    dtype, device = x0s.dtype, x0s.device
    ref = next(problem.buffers())
    if ref.device != device or ref.dtype != dtype:
        raise ValueError(
            f"x0s is {dtype} on {device} but the problem is {ref.dtype} on "
            f"{ref.device}; move one with .to(device, dtype)"
        )
    if x0s.dim() != 2 or x0s.shape[-1] != problem.nx:
        raise ValueError(f"x0s must be [B, {problem.nx}], got {tuple(x0s.shape)}")
    if params.max_iterations < 1:
        raise ValueError("max_iterations must be >= 1")
    if n_reg_levels < 1:
        raise ValueError("n_reg_levels must be >= 1")
    B = x0s.shape[0]
    kw = dict(dtype=dtype, device=device)
    affine = method is Method.PRIMAL_DUAL_AFFINE
    eps = torch.tensor(torch.finfo(dtype).eps, **kw)
    w_min = torch.tensor(params.w_min, **kw) if params.w_min is not None else 10.0 * eps**0.5
    threshold = torch.tensor(params.threshold, **kw)
    if n_linesearch is None:
        n_linesearch = 8
    if us_init is None:
        us_init = torch.zeros((B, T, nu), **kw)

    def constrain_jac(jac):
        return jac if affine else torch.zeros_like(jac)

    run_backward = _backward_kernel_levels if backward == "kernel" else _backward_multi_reg

    # --- pre-loop backward/forward ---
    xs = problem.rollout(x0s, us_init)
    us = us_init
    mults = al_mod.init_multipliers(problem, xs)
    mu = torch.full((B,), params.mu, **kw)
    reg = torch.full((B,), params.reg, **kw)
    w = torch.full((B,), params.w if params.w is not None else 1.0 / params.mu, **kw)
    n = torch.full((B,), params.n if params.n is not None else 1.0 / params.mu**0.1, **kw)

    derivs = problem.derivatives(xs, us)
    k, K, ok, reg_u = run_backward(derivs, mults.val, mults.jac, mu, reg, n_reg_levels)
    xs1, us1, step = _linesearch_sweep(problem, xs, us, k, K, mults, mu, n_linesearch)
    # guard: a failed factorization poisons the candidate rollouts
    ok = ok & torch.isfinite(us1.sum(dim=(1, 2)))
    xs = _bwhere(ok, xs1, xs)
    us = _bwhere(ok, us1, us)
    # NaN gains from a failed factorization must never enter the carry
    fb = al_mod.AffineMults(
        _bwhere(ok, k, torch.zeros_like(k)),
        _bwhere(ok, K, torch.zeros_like(K)),
        xs[:, :-1],
    )
    # carry the reg level that factorized; escalate only if every level failed
    reg = torch.where(ok, reg_u, torch.maximum(reg, mu) * 2.0)
    oo_prev = torch.full((B,), torch.inf, **kw)
    just_changed = torch.ones(B, dtype=torch.bool, device=device)
    inner = torch.ones(B, dtype=torch.int32, device=device)  # pre-loop ran once

    for _ in range(params.max_iterations):
        derivs = problem.derivatives(xs, us)
        mults = al_mod.update_origin(model, mults, xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
        fbm = al_mod.update_origin(model, fb, xs)

        oo = al_mod.optimality_obj(problem, derivs, mults.val, mults.jac, mu)
        oc = al_mod.optimality_constr(derivs)
        olag = al_mod.optimality_lag(problem, derivs, mults.val, mults.jac)
        done = (olag < threshold) & (oc < threshold)

        plateau = (oo >= 0.1 * oo_prev) & ~just_changed
        gate = (oo < torch.maximum(w, w_min)) | plateau
        if params.inner_iters_max is not None:
            # bounded inner loop: force the gate open after K inner iterations
            gate = gate | (inner >= params.inner_iters_max)
        upd_s = ~done & gate & (oc < n)
        upd_f = ~done & gate & (oc >= n)

        # where-select (not gain·delta): a NaN delta under a closed gate must
        # not leak into the multipliers.  PRIMAL drops the feedback term.
        if method is Method.PRIMAL:
            fb_term = torch.zeros_like(derivs.eq)
            fb_term_jac = torch.zeros_like(derivs.eqx)
        else:
            fb_term = torch.einsum("btou,btu->bto", derivs.equ, fbm.val)
            fb_term_jac = torch.einsum("btou,btuj->btoj", derivs.equ, fbm.jac)
        val_upd = mults.val + mu[:, None, None] * (derivs.eq + fb_term)
        jac_upd = mults.jac + mu[:, None, None, None] * (derivs.eqx + fb_term_jac)
        if params.mult_max is not None:
            val_upd = torch.clamp(val_upd, -params.mult_max, params.mult_max)
            jac_upd = torch.clamp(jac_upd, -params.mult_max, params.mult_max)
        mults = mults._replace(
            val=_bwhere(upd_s, val_upd, mults.val),
            jac=constrain_jac(_bwhere(upd_s, jac_upd, mults.jac)),
        )
        mu_new = torch.where(upd_f, mu * params.mu_factor, mu)
        if params.mu_max is not None:
            mu_new = torch.minimum(mu_new, torch.tensor(params.mu_max, **kw))
        n_new = torch.where(
            upd_s,
            torch.maximum(n * mu**-0.9, threshold),
            torch.where(upd_f, mu_new**-0.1, n),
        )
        w_new = torch.where(upd_s, w / mu, w)

        k, K, ok, reg_u = run_backward(derivs, mults.val, mults.jac, mu_new, reg, n_reg_levels)
        xs1, us1, step = _linesearch_sweep(problem, xs, us, k, K, mults, mu_new, n_linesearch)
        ok = ok & torch.isfinite(us1.sum(dim=(1, 2)))
        # carry the reg level that factorized; relax it on a full accepted
        # step; escalate only if all levels failed (μ is never escalated
        # here: compounding it across iterations leaves the useful range)
        reg_relaxed = torch.where(reg_u / 2 < 1e-5, torch.zeros_like(reg_u), reg_u / 2)
        reg = torch.where(
            ok,
            torch.where(step >= 0.5, reg_relaxed, reg_u),
            torch.maximum(reg, mu_new) * 2.0,
        )
        fb = al_mod.AffineMults(
            _bwhere(ok, k, fb.val),
            _bwhere(ok, K, fb.jac),
            _bwhere(ok, xs[:, :-1], fb.origin),
        )
        xs = _bwhere(ok, xs1, xs)
        us = _bwhere(ok, us1, us)
        mu, w, n = mu_new, w_new, n_new
        oo_prev = oo
        just_changed = upd_s | upd_f
        inner = torch.where(just_changed, torch.ones_like(inner), inner + 1)

    derivs = problem.derivatives(xs, us)
    mults = al_mod.update_origin(model, mults, xs)
    return BatchSolveResult(
        xs=xs,
        us=us,
        fb_k=fb.val,
        fb_K=fb.jac,
        opt_constr=al_mod.optimality_constr(derivs),
        opt_lag=al_mod.optimality_lag(problem, derivs, mults.val, mults.jac),
        mu=mu,
        mults=mults,
        reg=reg,
        w=w,
        n=n,
    )
