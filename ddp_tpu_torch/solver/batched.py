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
whole batch (``backward="kernel"``, ``kernels/riccati_small.py``); the
dynamics Jacobians come from ``Problem.derivatives`` (``deriv="jvp"``) or
from the fd-derivatives kernels over all B·T samples (``deriv="kernel"``:
``kernels/fd_derivs.py``, and ``kernels/fd_derivs2.py`` with the dynamics
Hessian for a ``second_order`` problem); the line search is the parallel sweep
(``forward="sweep"``), the early-exit ladder (``forward="seq"``) or, for a
flat-lane problem, the fused line-search kernel (``forward="kernel"``,
``kernels/linesearch_flat.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ddp_tpu_torch.diagnostics.asserts import ddp_assert, val
from ddp_tpu_torch.kernels.fd_derivs import fd_derivs
from ddp_tpu_torch.kernels.fd_derivs2 import fd_derivs2
from ddp_tpu_torch.kernels.flat_problem import pack_problem
from ddp_tpu_torch.kernels.linesearch_flat import linesearch as linesearch_flat
from ddp_tpu_torch.kernels.riccati_small import backward_ladder
from ddp_tpu_torch.ocp.dynamics import EulerDynamics, _vector_space_config
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.riccati import backward_sweep
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


@al_mod.full_fp32_matmuls()
def _backward_sweep(derivs, mult_val, mult_jac, mu, reg):
    """One batched Riccati sweep (no retry): returns (k [B,T,nu],
    K [B,T,nu,ndx], ok [B])."""
    return backward_sweep(derivs, mult_val, mult_jac, mu, reg)[:3]


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


def _backward_kernel_levels(
    derivs, mult_val, mult_jac, mu, reg, n_levels, second_order=False
):
    """The Riccati kernel over the whole batch and the whole regularization
    ladder in one launch, keeping per lane the first level that factorized;
    ``second_order`` adds the rank-3 slabs for the full-DDP sweep.  Returns
    batch-major (k [B,T,m], K [B,T,m,n], ok [B], reg_used [B])."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    return backward_ladder(derivs, mult_val, mult_jac, mu, levels, second_order=second_order)


@al_mod.full_fp32_matmuls()
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


@al_mod.full_fp32_matmuls()
def _linesearch_seq(problem, xs, us, k, K, mults, mu, n_candidates):
    """Sequential early-exit line search: walk the step ladder 1, ½, ¼, …
    largest first and stop once every lane has accepted a candidate (or the
    ladder is spent); lanes that are done are select-masked.  Picks the same
    candidate as ``_linesearch_sweep`` (first accepted = largest accepted)
    but pays max-first-accept-index rollouts per call instead of always
    ``n_candidates`` — worth it when one rollout is heavy (arm-class
    dynamics).  Returns (xs, us, step [B])."""
    cost_old = al_mod.al_costs(problem, xs, us, mults, mu).sum(dim=-1)
    xs_b, us_b = xs, us
    step_b = torch.zeros_like(cost_old)
    done = torch.zeros(cost_old.shape, dtype=torch.bool, device=xs.device)
    for i in range(n_candidates):
        step = 2.0**-i
        xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step)
        delta = al_mod.al_costs(problem, xs_c, us_c, mults, mu).sum(dim=-1) - cost_old
        acc = ~done & (delta <= 0)
        xs_b = _bwhere(acc, xs_c, xs_b)
        us_b = _bwhere(acc, us_c, us_b)
        step_b = torch.where(acc, torch.full_like(step_b, step), step_b)
        done = done | acc
        # the loop's exit test reads the device: one host sync per candidate
        # (the semantics of a while loop over the batch's slowest lane)
        if bool(done.all()):
            break
    return xs_b, us_b, step_b


def _linesearch_kernel(problem, xs, us, k, K, mults, mu, n_candidates, flat):
    """The fused line-search kernel (``kernels/linesearch_flat.py``): one launch
    for all candidates, the incumbent row and the accepted rollout, on the
    problem ``flat`` as ``pack_problem`` packed it once for the solve.  It reads
    the multipliers as anchored at ``xs`` (``mults.origin == xs[:, :-1]``),
    which holds at both call sites: ``init_multipliers``/``update_origin``
    anchor them there just before.  Returns (xs, us, step [B])."""
    return linesearch_flat(
        problem, xs, us, k, K, mults.val, mults.jac, mu, n_candidates, flat=flat
    )


def _kernel_derivatives(problem):
    """``deriv="kernel"``: the derivative pass with the dynamics Jacobians
    from one fd-derivatives kernel call over all B·T samples, assembled into
    the Euler-step blocks

        fx = [[I, dt·I], [dt·∂a/∂q, I + dt·∂a/∂v]],  fu = [[0], [dt·M⁻¹]]

    and handed to ``Problem.derivatives`` as ``fx_fu``.  For a
    ``second_order`` problem the second-order kernel also gives the
    acceleration Hessian H over ζ = (q, v, τ) ≡ z = (dq, dv, du), and the
    Euler local map f(z) = [dq + dt·(v + dv); dv + dt·a(ζ + z)] has zero
    Hessian in its q-rows and dt·H in its v-rows (``f_hess``)."""
    model, dyn = problem.model, problem.dynamics
    if not (
        isinstance(dyn, EulerDynamics)
        and dyn.analytic_jacobians_ok
        and hasattr(model, "joint_types")
        # the kernel and the fx assembly below are vector-space only;
        # manifold models take deriv="jvp"
        and _vector_space_config(model)
    ):
        raise ValueError(
            "deriv='kernel' needs Euler dynamics on a revolute/prismatic RobotModel"
        )
    nq, nv, nu, ndx = model.nq, model.nv, problem.nu, problem.ndx
    if problem.second_order and nu != nv:
        raise ValueError(
            "deriv='kernel' full DDP needs direct torque actuation "
            "(nu == nv); use deriv='jvp'"
        )

    def derivatives(xs, us):
        B, T = us.shape[0], us.shape[1]
        kw = dict(dtype=xs.dtype, device=xs.device)
        q = xs[:, :-1, :nq].reshape(B * T, nq)
        v = xs[:, :-1, nq:].reshape(B * T, nv)
        tau = us.reshape(B * T, nu)
        if problem.second_order:
            _, A, Bv, Mi, H = fd_derivs2(model, q, v, tau)
        else:
            _, A, Bv, Mi = fd_derivs(model, q, v, tau)
        dt = dyn.dt
        I = torch.eye(nv, **kw).expand(B * T, nv, nv)
        top = torch.cat([I, dt * I], dim=2)
        bot = torch.cat([dt * A, I + dt * Bv], dim=2)
        fx = torch.cat([top, bot], dim=1).reshape(B, T, ndx, ndx)
        fu = torch.cat([torch.zeros(B * T, nv, nu, **kw), dt * Mi], dim=1)
        fx_fu = (fx, fu.reshape(B, T, ndx, nu))
        if not problem.second_order:
            return problem.derivatives(xs, us, fx_fu=fx_fu)
        nz = ndx + nu
        fzz = torch.cat([torch.zeros(B * T, nv, nz, nz, **kw), dt * H], dim=1)
        return problem.derivatives(
            xs, us, fx_fu=fx_fu, f_hess=fzz.reshape(B, T, ndx, nz, nz)
        )

    return derivatives


def _check_backends(backward, forward, deriv):
    deferred = {
        ("backward", "assoc"): "ROADMAP slice H",
        ("backward", "tf"): "ROADMAP slice G",
    }
    supported = {
        "backward": ("sweep", "kernel"),
        "forward": ("sweep", "seq", "kernel"),
        "deriv": ("jvp", "kernel"),
    }
    for knob, value in (("backward", backward), ("forward", forward), ("deriv", deriv)):
        if (knob, value) in deferred:
            raise NotImplementedError(
                f"{knob}={value!r} is still to be ported ({deferred[knob, value]})"
            )
        if value not in supported[knob]:
            hint = '; ddp_tpu\'s "pallas" backend is "kernel" here' if value == "pallas" else ""
            raise ValueError(
                f"unknown {knob} backend {value!r}; have {supported[knob]}{hint}"
            )


def solve_batched(
    problem,
    params: SolverParams,
    x0s: torch.Tensor,  # [B, nx]
    us_init: torch.Tensor | None = None,  # [B, T, nu]
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    n_linesearch: int | None = None,
    # default 8 candidates (1 … 1/128); 7 (1 … 1/64) with forward="kernel",
    # as ddp_tpu's forward="pallas"
    backward: str = "sweep",
    # "sweep": batched PyTorch Riccati sweep with the parallel reg ladder
    # "kernel": the Riccati kernel (kernels/riccati_small.py), one launch over
    #   the whole batch and every reg level
    forward: str = "sweep",
    # "sweep": every step candidate rolled out in one [S, B] batch
    # "seq": early-exit ladder, largest step first, until every lane has
    #   accepted; the same accepted step as "sweep", ~1 rollout per iteration
    #   near convergence — for models whose rollout is heavy (arms)
    # "kernel": the fused line-search kernel (kernels/linesearch_flat.py), one
    #   launch per iteration, for a flat-lane problem (kernels/flat_problem.py;
    #   anything else raises ValueError); any n_linesearch from 1 to 31, where
    #   ddp_tpu's forward="pallas" clamps to 7
    deriv: str = "jvp",
    # "jvp": Problem.derivatives (assembled Euler Jacobians from the model's
    #   fd_derivatives)
    # "kernel": the fd-derivatives kernel over all B·T samples
    #   (kernels/fd_derivs.py; kernels/fd_derivs2.py with the dynamics Hessian
    #   when problem.second_order, which needs nu == nv); Euler dynamics on a
    #   revolute/prismatic RobotModel
    n_reg_levels: int = 4,  # parallel regularization ladder depth (≥1)
    matmul_precision: str | None = None,
    # None → the process setting | "highest" → full-float32 matmuls |
    # "high"/"default" → TF32 matmuls allowed on the card for this call
    mults_init: al_mod.AffineMults | None = None,  # [B, T, …] warm-start multipliers
    mu_init: torch.Tensor | float | None = None,  # [B] (or scalar) warm-start μ
    reg_init: torch.Tensor | float | None = None,  # [B] (or scalar) warm-start reg
    w_init: torch.Tensor | float | None = None,  # [B] inner-gate tolerance state
    n_init: torch.Tensor | float | None = None,  # [B] progress-gate tolerance state
) -> BatchSolveResult:
    """Fixed-budget batched AL-DDP: exactly ``params.max_iterations`` outer
    iterations for every lane (converged lanes no-op through the line search
    keeping their trajectory).  The problem's buffers and ``x0s`` must share
    one device and dtype.

    The ``*_init`` arguments warm-start a solve from a previous result's
    (mults, mu, reg, w, n) — e.g. a Gauss-Newton solve to feasibility followed
    by a few full-DDP iterations on the ``second_order`` twin of the problem;
    the multipliers are re-anchored at the new initial rollout."""
    _check_backends(backward, forward, deriv)
    with al_mod.matmul_precision(matmul_precision):
        return _solve_batched(
            problem, params, x0s, us_init, method, n_linesearch, backward,
            forward, deriv, n_reg_levels,
            (mults_init, mu_init, reg_init, w_init, n_init),
        )  # fmt: skip


def _solve_batched(
    problem, params, x0s, us_init, method, n_linesearch, backward, forward,
    deriv, n_reg_levels, warm,
):  # fmt: skip
    T, nu = problem.horizon, problem.nu
    model = problem.model
    dtype, device = x0s.dtype, x0s.device
    ref = next(problem.buffers())
    if ref.device != device or ref.dtype != dtype:
        raise ValueError(
            f"x0s is {dtype} on {device} but the problem is {ref.dtype} on "
            f"{ref.device}; move one with .to(device, dtype)"
        )
    ddp_assert(
        val(x0s.ndim, "x0s.ndim") == 2,
        val(x0s.shape[-1], "x0s state dim") == problem.nx,
        val(params.max_iterations, "max_iterations") >= 1,
        msg="solve_batched() preconditions",
    )
    if n_reg_levels < 1:
        raise ValueError("n_reg_levels must be >= 1")
    B = x0s.shape[0]
    kw = dict(dtype=dtype, device=device)
    affine = method is Method.PRIMAL_DUAL_AFFINE
    eps = torch.tensor(torch.finfo(dtype).eps, **kw)
    w_min = torch.tensor(params.w_min, **kw) if params.w_min is not None else 10.0 * eps**0.5
    threshold = torch.tensor(params.threshold, **kw)
    if n_linesearch is None:
        # ddp_tpu's forward="pallas" default (1 … 1/64), else its sweep's
        n_linesearch = 7 if forward == "kernel" else 8
    if us_init is None:
        us_init = torch.zeros((B, T, nu), **kw)

    def constrain_jac(jac):
        return jac if affine else torch.zeros_like(jac)

    if backward == "kernel":
        run_backward = functools.partial(
            _backward_kernel_levels, second_order=problem.second_order
        )
    else:
        run_backward = _backward_multi_reg
    if forward == "kernel":
        # packed once a solve; raises for a problem outside the flat-lane class
        linesearch = functools.partial(_linesearch_kernel, flat=pack_problem(problem))
    else:
        linesearch = {"sweep": _linesearch_sweep, "seq": _linesearch_seq}[forward]
    derivatives = _kernel_derivatives(problem) if deriv == "kernel" else problem.derivatives

    # --- pre-loop backward/forward ---
    xs = problem.rollout(x0s, us_init)
    us = us_init
    mults_init, mu_init, reg_init, w_init, n_init = warm

    def lane_state(init, default):
        """A [B] schedule state: the warm-start value (scalar or [B]) or the
        params' default."""
        if init is None:
            return torch.full((B,), default, **kw)
        return torch.as_tensor(init, **kw).expand(B).contiguous()

    if mults_init is None:
        mults = al_mod.init_multipliers(problem, xs)
    else:
        # warm start: re-express the affine functions about the new rollout
        mults = al_mod.update_origin(model, mults_init, xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
    mu = lane_state(mu_init, params.mu)
    reg = lane_state(reg_init, params.reg)
    w = lane_state(w_init, params.w if params.w is not None else 1.0 / params.mu)
    n = lane_state(n_init, params.n if params.n is not None else 1.0 / params.mu**0.1)

    derivs = derivatives(xs, us)
    k, K, ok, reg_u = run_backward(derivs, mults.val, mults.jac, mu, reg, n_reg_levels)
    xs1, us1, step = linesearch(problem, xs, us, k, K, mults, mu, n_linesearch)
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
        derivs = derivatives(xs, us)
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
        xs1, us1, step = linesearch(problem, xs, us, k, K, mults, mu_new, n_linesearch)
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

    derivs = derivatives(xs, us)
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
