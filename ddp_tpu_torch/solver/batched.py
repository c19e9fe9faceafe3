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

The batch is the leading dim of every tensor; the backward pass is a batched
PyTorch sweep (``backward="sweep"``), the Riccati kernel over the whole batch
(``backward="kernel"``, ``kernels/riccati_small.py``), the associative-scan
sweep (``backward="assoc"``, ``solver/parallel_riccati.py``) or the sweep in
float64 (``backward="tf"``, ``solver/precise.py``); the
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
from ddp_tpu_torch.solver import precise
from ddp_tpu_torch.solver.parallel_riccati import backward_pass_assoc
from ddp_tpu_torch.solver.riccati import backward_sweep
from ddp_tpu_torch.solver.rollout import feedback_rollout
from ddp_tpu_torch.solver.solve import Method, SolverParams


class BatchSolveHistory(NamedTuple):
    """Per-iteration solver state for the whole batch, [I, B] each: the
    production path's counterpart of solve(history=True)'s SolveHistory.
    Recorded by solve_batched(..., history=True) after each outer iteration;
    the pre-loop backward/forward pair is not an outer iteration and is not
    recorded."""

    mu: torch.Tensor
    reg: torch.Tensor
    step: torch.Tensor
    opt_obj: torch.Tensor
    opt_lag: torch.Tensor
    opt_constr: torch.Tensor
    upd_success: torch.Tensor
    upd_failure: torch.Tensor


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
    history: BatchSolveHistory | None = None  # history=True only


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


def _backward_multi_reg(derivs, mult_val, mult_jac, mu, reg, n_levels, sweep=None):
    """Run the sweep at every reg level of the ladder in one batch and keep,
    per lane, the smallest level that factorizes everywhere.  Returns
    (k, K, ok, reg_used); a lane with no good level keeps level 0.
    ``sweep`` replaces the sweep at the problem's dtype (``backward="tf"``:
    ``precise.backward_sweep``; the ladder stays at μ's dtype)."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))  # [L, B]
    L, B = levels.shape

    def rep(x):
        return x.repeat((L,) + (1,) * (x.dim() - 1))

    ks, Ks, oks = (sweep or _backward_sweep)(
        type(derivs)(*map(rep, derivs)), rep(mult_val), rep(mult_jac),
        rep(mu), levels.reshape(L * B),
    )  # fmt: skip
    oks = oks.reshape(L, B)
    idx = torch.argmax(oks.to(torch.int32), dim=0)  # first successful level
    lane = torch.arange(B, device=mu.device)
    ks = ks.reshape((L, B) + ks.shape[1:])[idx, lane]
    Ks = Ks.reshape((L, B) + Ks.shape[1:])[idx, lane]
    return ks, Ks, oks.any(dim=0), levels[idx, lane]


def _backward_assoc(derivs, mult_val, mult_jac, mu, reg, n_levels):
    """The associative-scan backward: no ladder (``n_levels`` unread), each
    lane's reg folded into its control cost, so reg_used is reg."""
    del n_levels
    k, K, ok = backward_pass_assoc(derivs, mult_val, mult_jac, mu, reg)
    return k, K, ok, reg


def _backward_kernel_levels(
    derivs, mult_val, mult_jac, mu, reg, n_levels, second_order=False
):
    """The Riccati kernel over the whole batch and the whole regularization
    ladder in one launch, keeping per lane the first level that factorized;
    ``second_order`` adds the rank-3 slabs for the full-DDP sweep.  Returns
    batch-major (k [B,T,m], K [B,T,m,n], ok [B], reg_used [B])."""
    levels = torch.stack(_reg_levels(mu, reg, n_levels))
    return backward_ladder(derivs, mult_val, mult_jac, mu, levels, second_order=second_order)


def _al_cost_total(problem, xs, us, mults, mu):
    """Σ_t AL cost per trajectory at the problem's dtype."""
    return al_mod.al_costs(problem, xs, us, mults, mu).sum(dim=-1)


@al_mod.full_fp32_matmuls()
def _linesearch_sweep(problem, xs, us, k, K, mults, mu, n_candidates, total=_al_cost_total):
    """Parallel line search: roll out every candidate step in one batch
    [S, B, …], take per lane the largest step whose AL cost did not rise,
    keep the incumbent where none did.  ``total`` (problem, xs, us, mults,
    μ) → Σ AL cost decides it (``precise_cost``: float64 sums, the test on
    their float64 difference).  Returns (xs, us, step [B])."""
    S, B = n_candidates, xs.shape[0]
    steps = torch.tensor(
        [2.0**-i for i in range(S)], dtype=xs.dtype, device=xs.device
    )  # 1, ½, ¼, …

    def ex(x):
        return x.expand((S,) + x.shape)

    cost_old = total(problem, xs, us, mults, mu)
    xs_c, us_c = feedback_rollout(
        problem, ex(xs), ex(us), ex(k), ex(K), steps[:, None, None]
    )
    cost_c = total(problem, xs_c, us_c, al_mod.AffineMults(*map(ex, mults)), ex(mu))  # [S, B]
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
def _linesearch_seq(problem, xs, us, k, K, mults, mu, n_candidates, total=_al_cost_total, dead=None):
    """Sequential early-exit line search: walk the step ladder 1, ½, ¼, …
    largest first and stop once every lane has accepted a candidate (or the
    ladder is spent); lanes that are done are select-masked.  Picks the same
    candidate as ``_linesearch_sweep`` (first accepted = largest accepted)
    but pays max-first-accept-index rollouts per call instead of always
    ``n_candidates`` — worth it when one rollout is heavy (arm-class
    dynamics).  ``total`` as ``_linesearch_sweep``'s.

    ``dead`` ([B] bool, ``solve_batched``'s ``give_up_after``) marks lanes
    that have given up: they enter the ladder done, keep their incumbent at
    step 0 and no longer keep the loop going, so one μ-racing lane that
    rejects every candidate stops holding the whole batch to the full ladder.
    With every lane dead no rollout runs at all.  Returns (xs, us, step
    [B])."""
    if dead is not None and bool(dead.all()):
        return xs, us, torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)
    cost_old = total(problem, xs, us, mults, mu)
    xs_b, us_b = xs, us
    step_b = torch.zeros_like(cost_old)
    done = torch.zeros(cost_old.shape, dtype=torch.bool, device=xs.device) if dead is None else dead
    for i in range(n_candidates):
        step = 2.0**-i
        xs_c, us_c = feedback_rollout(problem, xs, us, k, K, step)
        delta = total(problem, xs_c, us_c, mults, mu) - cost_old
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
    supported = {
        "backward": ("sweep", "kernel", "assoc", "tf"),
        "forward": ("sweep", "seq", "kernel"),
        "deriv": ("jvp", "kernel"),
    }
    for knob, value in (("backward", backward), ("forward", forward), ("deriv", deriv)):
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
    # "assoc": associative-scan Riccati (solver/parallel_riccati.py), log-depth
    #   in T; Gauss-Newton only (second_order raises ValueError); reg folded
    #   into the control cost, no ladder
    # "tf": the sweep and its ladder in float64 on the problem's float32
    #   values, gains rounded back (ddp_tpu's double-float sweep)
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
    give_up_after: int | None = None,  # forward="seq" only: a lane that has
    # rejected the whole candidate ladder (step 0) for this many consecutive
    # outer iterations is dead — it stops line-searching (no longer holding
    # the batch's early-exit ladder to its full depth) and its multipliers,
    # μ, w, n and reg freeze; its gains are whatever the batch's backward
    # gives.  None = never give up; ≤ 0 raises ValueError
    precise_cost: bool = False,  # line-search acceptance sums in float64
    # (on a float64 twin of the problem); forward="kernel" raises ValueError
    matmul_precision: str | None = None,
    # None → the process setting | "highest" → full-float32 matmuls |
    # "high"/"default" → TF32 matmuls allowed on the card for this call
    mults_init: al_mod.AffineMults | None = None,  # [B, T, …] warm-start multipliers
    mu_init: torch.Tensor | float | None = None,  # [B] (or scalar) warm-start μ
    reg_init: torch.Tensor | float | None = None,  # [B] (or scalar) warm-start reg
    w_init: torch.Tensor | float | None = None,  # [B] inner-gate tolerance state
    n_init: torch.Tensor | float | None = None,  # [B] progress-gate tolerance state
    history: bool = False,  # record BatchSolveHistory ([I, B] per iteration)
) -> BatchSolveResult:
    """Fixed-budget batched AL-DDP: exactly ``params.max_iterations`` outer
    iterations for every lane (converged lanes no-op through the line search
    keeping their trajectory).  The problem's buffers and ``x0s`` must share
    one device and dtype.

    The ``*_init`` arguments warm-start a solve from a previous result's
    (mults, mu, reg, w, n) — e.g. a Gauss-Newton solve to feasibility followed
    by a few full-DDP iterations on the ``second_order`` twin of the problem;
    the multipliers are re-anchored at the new initial rollout.
    ``history=True`` records ``BatchSolveHistory`` after each outer
    iteration; the result is the same bits with it as without."""
    _check_backends(backward, forward, deriv)
    if give_up_after is not None and forward != "seq":
        raise ValueError(
            "give_up_after only applies to forward='seq' (the early-exit ladder "
            "is what dead lanes would otherwise hold hostage)"
        )
    if give_up_after is not None and give_up_after <= 0:
        # ddp_tpu accepts it and freezes every lane from the first iteration
        raise ValueError(f"give_up_after must be >= 1 (or None), got {give_up_after}")
    if precise_cost and forward == "kernel":
        # ddp_tpu's forward="pallas" leaves precise_cost unread
        # (ddp_tpu/solver/batched.py:630-657); the port refuses it
        raise ValueError("precise_cost=True needs forward='sweep' or 'seq'")
    with al_mod.matmul_precision(matmul_precision):
        return _solve_batched(
            problem, params, x0s, us_init, method, n_linesearch, backward,
            forward, deriv, n_reg_levels, give_up_after, precise_cost,
            (mults_init, mu_init, reg_init, w_init, n_init), history,
        )  # fmt: skip


def _solve_batched(
    problem, params, x0s, us_init, method, n_linesearch, backward, forward,
    deriv, n_reg_levels, give_up_after, precise_cost, warm, history,
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
    if backward == "assoc" and problem.second_order:
        raise ValueError(
            "backward='assoc' is Gauss-Newton only; build the Problem with second_order=False"
        )
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
    elif backward == "assoc":
        run_backward = _backward_assoc
    elif backward == "tf":
        run_backward = functools.partial(_backward_multi_reg, sweep=precise.backward_sweep)
    else:
        run_backward = _backward_multi_reg
    if forward == "kernel":
        # packed once a solve; raises for a problem outside the flat-lane class
        linesearch = functools.partial(_linesearch_kernel, flat=pack_problem(problem))
    else:
        linesearch = {"sweep": _linesearch_sweep, "seq": _linesearch_seq}[forward]
        if precise_cost:
            twin64 = precise.twin(problem)  # once a solve

            def total(problem_, xs_, us_, mults_, mu_):
                return precise.al_cost_total(twin64, xs_, us_, mults_, mu_)

            linesearch = functools.partial(linesearch, total=total)
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
    # consecutive outer iterations at step 0 (give_up_after's count)
    streak = torch.where(ok & (step > 0), 0, 1).to(torch.int32)
    rows = []

    for _ in range(params.max_iterations):
        # give_up_after=None: no lane is ever dead, and the loop below is the
        # one without the mask
        dead = None if give_up_after is None else streak >= give_up_after
        derivs = derivatives(xs, us)
        mults = al_mod.update_origin(model, mults, xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
        fbm = al_mod.update_origin(model, fb, xs)

        oo = al_mod.optimality_obj(problem, derivs, mults.val, mults.jac, mu)
        oc = al_mod.optimality_constr(derivs)
        olag = al_mod.optimality_lag(problem, derivs, mults.val, mults.jac)
        done = (olag < threshold) & (oc < threshold)
        if dead is not None:
            # a dead lane's schedule freezes: no multiplier update, no μ
            # escalation, no gate-tolerance motion
            done = done | dead

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
        ls_dead = {} if dead is None else dict(dead=dead)
        xs1, us1, step = linesearch(problem, xs, us, k, K, mults, mu_new, n_linesearch, **ls_dead)
        ok = ok & torch.isfinite(us1.sum(dim=(1, 2)))
        # carry the reg level that factorized; relax it on a full accepted
        # step; escalate only if all levels failed (μ is never escalated
        # here: compounding it across iterations leaves the useful range)
        reg_relaxed = torch.where(reg_u / 2 < 1e-5, torch.zeros_like(reg_u), reg_u / 2)
        reg_new = torch.where(
            ok,
            torch.where(step >= 0.5, reg_relaxed, reg_u),
            torch.maximum(reg, mu_new) * 2.0,
        )
        # a dead lane's reg stays (×2 an iteration would overflow f32)
        reg = reg_new if dead is None else torch.where(dead, reg, reg_new)
        streak = torch.where(ok & (step > 0), 0, streak + 1).to(torch.int32)
        fb = al_mod.AffineMults(
            _bwhere(ok, k, fb.val),
            _bwhere(ok, K, fb.jac),
            _bwhere(ok, xs[:, :-1], fb.origin),
        )
        xs = _bwhere(ok, xs1, xs)
        us = _bwhere(ok, us1, us)
        if history:
            rows.append(BatchSolveHistory(mu_new, reg, step, oo, olag, oc, upd_s, upd_f))
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
        history=BatchSolveHistory(*map(torch.stack, zip(*rows))) if history else None,
    )
