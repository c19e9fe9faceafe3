"""Top-level equality-constrained DDP solve of one trajectory: the
augmented-Lagrangian outer loop (≙ ddp_tpu/solver/solve.py).

Control flow, as the reference's (ddp.hpp:744-842) and ``ddp_tpu``'s:

    outer loop with early exit         Python while, ``done`` read each iteration
    multiplier update decision tree    0-d tensor updates (torch.where)
    backward restart loop              riccati.backward_pass
    line-search halving loop           rollout.forward_pass

``solve`` runs one trajectory; the batched throughput path is
``solver/batched.py::solve_batched``.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ddp_tpu_torch.diagnostics.asserts import ddp_assert, val
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver.riccati import backward_pass
from ddp_tpu_torch.solver.rollout import forward_pass


class Method(enum.Enum):
    """PRIMAL and PRIMAL_DUAL_CONSTANT keep the multiplier state-independent
    (jac pinned to zero); AFFINE gives multipliers a state-feedback term
    re-expanded each iteration.  PRIMAL additionally drops the control-
    feedback correction from the multiplier update: p += μ·eq instead of
    p += μ·(eq + eq_u·k) (see ddp_tpu.solver.solve.Method)."""

    PRIMAL = "primal"
    PRIMAL_DUAL_CONSTANT = "primal_dual_constant_multipliers"
    PRIMAL_DUAL_AFFINE = "primal_dual_affine_multipliers"


class SolverParams(NamedTuple):
    """AL schedule parameters.  w/n default to w = 1/μ, n = 1/μ^0.1.

    - ``w_min``: floor on the inner-convergence tolerance w; None → scaled
      to the dtype as 10·sqrt(eps).
    - ``inner_iters_max``: bound on inner Newton iterations between
      multiplier/μ updates; None → the gate opens only via w or the
      plateau test.
    - ``mu_factor``/``mu_max``: penalty growth on update failure and its cap.
    - ``mult_max``: elementwise clip of the multipliers after each update
      (needed whenever mu_max is finite).
    """

    max_iterations: int
    threshold: float
    mu: float
    reg: float = 0.0
    w: float | None = None
    n: float | None = None
    w_min: float | None = None
    inner_iters_max: int | None = None
    mu_factor: float = 10.0
    mu_max: float | None = None
    mult_max: float | None = None


class SolveStats(NamedTuple):
    iterations: torch.Tensor
    opt_lag: torch.Tensor  # μ-free Lagrangian stationarity (the stopping measure)
    opt_obj: torch.Tensor  # μ-dependent AL stationarity (the update-gate measure)
    opt_constr: torch.Tensor
    mu: torch.Tensor
    reg: torch.Tensor
    step: torch.Tensor
    converged: torch.Tensor


class SolveHistory(NamedTuple):
    """Per-iteration solver state, stacked over the iteration axis [I]; rows
    after convergence repeat the converged state."""

    mu: torch.Tensor  # penalty after this iteration's update decision
    reg: torch.Tensor  # regularization after the backward/forward pair
    w: torch.Tensor  # inner-convergence tolerance
    n: torch.Tensor  # constraint-progress tolerance
    step: torch.Tensor  # accepted line-search step
    opt_obj: torch.Tensor
    opt_lag: torch.Tensor
    opt_constr: torch.Tensor
    upd_success: torch.Tensor  # bool: the first-order multiplier update fired
    upd_failure: torch.Tensor  # bool: the μ escalation fired
    done: torch.Tensor  # bool: converged at iteration start


class SolveResult(NamedTuple):
    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    fb_k: torch.Tensor  # [T, nu]       feedforward (for MPC warm starts)
    fb_K: torch.Tensor  # [T, nu, ndx]  feedback gains
    mults: object  # al.AffineMults [T, …]
    stats: SolveStats
    history: SolveHistory | None = None  # solve(..., history=True) only


class _Carry(NamedTuple):
    """The outer loop's state; every field has the leading batch shape [...]
    (none for one trajectory) before its own dims."""

    it: torch.Tensor  # int
    done: torch.Tensor  # bool
    xs: torch.Tensor
    us: torch.Tensor
    mults: object
    fb: object  # AffineMults of the last committed gains (k, K, origin)
    mu: torch.Tensor
    reg: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    opt_lag: torch.Tensor
    opt_constr: torch.Tensor
    step: torch.Tensor
    opt_obj_prev: torch.Tensor
    just_changed: torch.Tensor  # bool: (p, μ) changed last iteration
    inner: torch.Tensor  # int: inner iterations since the last (p, μ) change


def solve(
    problem,
    params: SolverParams,
    x_init: torch.Tensor,
    us_init: torch.Tensor | None = None,
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    precise: bool | str = False,
    mults_init_jac: torch.Tensor | None = None,
    history: bool = False,
    matmul_precision: str | None = None,
    reference_schedule: bool = False,
) -> SolveResult:
    """Solve one trajectory from ``x_init`` [nx] (controls ``us_init``
    [T, nu], zeros by default) on the device and in the dtype of ``x_init``,
    which the problem's buffers must share.

    ``mults_init_jac`` [T, ne, ndx]: the multipliers' initial state-feedback
    term (the reference's random startup, ddp.hpp:760-764).
    ``history=True`` records per-iteration state (``SolveHistory``) and runs
    all ``max_iterations`` rows, the converged state repeated, with the same
    final iterate.  ``matmul_precision``: None | "highest" | "high" |
    "default", as ``solve_batched``'s; the backward pass, the line search,
    the optimality adjoints and ``update_origin`` run in full float32 under
    any setting.  ``reference_schedule=True`` runs the reference's exact
    outer loop: the raw ``opt_obj < w`` gate (no w_min floor, plateau or
    inner cap), μ·``mu_factor`` on failure with w and n unchanged, on
    success n = opt_obj(new multipliers)/μ^0.1 and w /= μ, stopping on
    opt_obj, and the pre-loop forward result discarded.

    ``precise=True`` runs the stages where float32 binds the solver in
    float64 on the float32 problem's values (``solver/precise.py``, ddp_tpu's
    double-float envelope): the Riccati sweep, the line-search acceptance
    sums, the optimality adjoints and the multiplier accumulation; the
    iterate stays float32.  ``precise="storage"`` also keeps the iterate
    (xs, us) and the multipliers in float64 and evaluates the dynamics, the
    constraint and the derivatives on a float64 copy of the problem; it
    accepts the classes ddp_tpu's ``supports_tf_storage`` accepts and raises
    ``ValueError`` for any other.  Either way the schedule's constants and
    state (μ, reg, w, n, the gate measures) stay at the problem's dtype, and
    the result comes back in it."""
    return _solve_with(
        problem, params, x_init, us_init, method, precise, mults_init_jac, history,
        matmul_precision, reference_schedule, batched=False,
    )  # fmt: skip


def solve_vmap(
    problem,
    params: SolverParams,
    x0s: torch.Tensor,
    us_init: torch.Tensor | None = None,
    method: Method = Method.PRIMAL_DUAL_AFFINE,
    precise: bool | str = False,
    mults_init_jac: torch.Tensor | None = None,
    history: bool = False,
    matmul_precision: str | None = None,
    reference_schedule: bool = False,
) -> SolveResult:
    """``solve`` of each row of ``x0s`` [B, nx] (≙ ``jax.vmap(lambda x:
    solve(problem, params, x, …))(x0s)``): every field of the result, the
    stats and the history included, gains a leading [B].

    The trajectories run batch-major, one batched iteration at a time, while
    any of them is live (not converged and under ``max_iterations``).  Each
    decision of ``solve``'s loop is taken per lane: the stopping test, the
    multiplier-update gate, the backward pass's retries (a lane climbs reg
    and μ only while its own factorization fails) and the halving line
    search (a lane keeps its step once it accepts).  A lane that is done is
    frozen: its state stays bit for bit what it was, as under ``vmap`` of
    ``lax.while_loop``.  ``us_init`` [B, T, nu] and ``mults_init_jac``
    [B, T, ne, ndx] are per lane; the other arguments are ``solve``'s.  The
    backward is the sweep, as ``solve``'s."""
    return _solve_with(
        problem, params, x0s, us_init, method, precise, mults_init_jac, history,
        matmul_precision, reference_schedule, batched=True,
    )  # fmt: skip


def _solve_with(problem, params, x_init, us_init, method, precise, mults_init_jac, history,
                matmul_precision, reference_schedule, batched):  # fmt: skip
    if precise:
        from ddp_tpu_torch.solver import precise as precise_mod

        stages = precise_mod.stages_for(problem, precise)
    else:
        stages = Stages(problem)
    with al_mod.matmul_precision(matmul_precision):
        return _solve(
            problem, params, x_init, us_init, method, mults_init_jac, history,
            reference_schedule, stages, batched,
        )  # fmt: skip


class Stages:
    """The stages of one ``solve`` iteration at the problem's dtype, over
    trajectories with any leading batch dims (none in ``solve``, [B] in
    ``solve_vmap``).  ``solver/precise.py`` widens them to float64 for
    ``solve(precise=…)``; the loop around them and the schedule are the
    same."""

    def __init__(self, problem):
        self.problem = problem
        self.model = problem.model  # the one the iterate and the multipliers live on

    def rollout(self, x_init, us_init):
        return self.problem.rollout(x_init, us_init)

    def carry(self, x):
        """A problem-dtype iterate tensor as the solve carries it."""
        return x

    @staticmethod
    def derivatives_of(problem, xs, us):
        """``problem.derivatives`` of a batch of trajectories, or of one
        (a batch dim added and dropped)."""
        if xs.dim() > 2:
            return problem.derivatives(xs, us)
        d = problem.derivatives(xs[None], us[None])
        return type(d)(*(f[0] for f in d))

    def derivatives(self, xs, us):
        return self.derivatives_of(self.problem, xs, us)

    def init_mults(self, xs, jac_init):
        return al_mod.init_multipliers(self.problem, xs, jac_init=jac_init)

    def update_origin(self, mults, xs):
        return al_mod.update_origin(self.model, mults, xs)

    def opt_obj(self, derivs, mults, mu):
        return al_mod.optimality_obj(self.problem, derivs, mults.val, mults.jac, mu)

    def opt_lag(self, derivs, mults):
        return al_mod.optimality_lag(self.problem, derivs, mults.val, mults.jac)

    def opt_constr(self, derivs):
        return al_mod.optimality_constr(derivs)

    def increments(self, derivs, fb, xs, feedback):
        """The AL update's increments (eq + eq_u·k, eq_x + eq_u·K), with
        the last gains re-anchored at ``xs``; without ``feedback`` (PRIMAL)
        just (eq, eq_x)."""
        if not feedback:
            return derivs.eq, derivs.eqx
        fbm = al_mod.update_origin(self.model, fb, xs)
        fb_term = torch.einsum("...tou,...tu->...to", derivs.equ, fbm.val)
        fb_term_jac = torch.einsum("...tou,...tuj->...toj", derivs.equ, fbm.jac)
        return derivs.eq + fb_term, derivs.eqx + fb_term_jac

    def mult_update(self, mults, gain, val_inc, jac_inc, mult_max):
        """p += gain·(eq + eq_u·k), p_x += gain·(eq_x + eq_u·K), clipped to
        ±``mult_max`` when it is set (see SolverParams); ``gain`` has the
        batch shape."""
        new_val = mults.val + _lanes(gain, val_inc) * val_inc
        new_jac = mults.jac + _lanes(gain, jac_inc) * jac_inc
        if mult_max is not None:
            new_val = torch.clamp(new_val, -mult_max, mult_max)
            new_jac = torch.clamp(new_jac, -mult_max, mult_max)
        return mults._replace(val=new_val, jac=new_jac)

    def backward(self, derivs, mults, mu, reg, live=None):
        return backward_pass(derivs, mults.val, mults.jac, mu, reg, live=live)

    def forward(self, xs, us, k, K, mults, mu, live=None):
        return forward_pass(self.problem, xs, us, k, K, mults, mu, live=live)

    def result(self, x):
        """An iterate, gain or multiplier tensor as the result carries it."""
        return x


def _lanes(mask_or_value, x):
    """A per-lane tensor [...] viewed to broadcast against ``x`` [..., *dims]."""
    return mask_or_value.reshape(mask_or_value.shape + (1,) * (x.dim() - mask_or_value.dim()))


def _pick(cond, new, old):
    """``new`` where the per-lane bool ``cond`` holds, else ``old``, over
    tensors and NamedTuples of tensors."""
    if isinstance(new, torch.Tensor):
        return torch.where(_lanes(cond, new), new, old)
    return type(new)(*(_pick(cond, a, b) for a, b in zip(new, old)))


def _solve(
    problem, params, x_init, us_init, method, mults_init_jac, history, reference_schedule, stages,
    batched,
):  # fmt: skip
    T, nu = problem.horizon, problem.nu
    dtype, device = x_init.dtype, x_init.device
    ref = next(problem.buffers())
    if ref.device != device or ref.dtype != dtype:
        raise ValueError(
            f"x_init is {dtype} on {device} but the problem is {ref.dtype} on "
            f"{ref.device}; move one with .to(device, dtype)"
        )
    if batched:
        shape = (val(x_init.dim(), "x0s.ndim") == 2,
                 val(tuple(x_init.shape[1:]), "x0s.shape[1:]") == (problem.nx,))  # fmt: skip
    else:
        shape = (val(tuple(x_init.shape), "x_init.shape") == (problem.nx,),)
    ddp_assert(
        *shape,
        val(params.max_iterations, "max_iterations") >= 1,
        val(params.mu, "mu") > 0.0,
        msg="solve_vmap() preconditions" if batched else "solve() preconditions",
    )
    lanes = tuple(x_init.shape[:-1])
    kw = dict(dtype=dtype, device=device)
    if us_init is None:
        us_init = torch.zeros(lanes + (T, nu), **kw)
    else:
        ddp_assert(
            val(tuple(us_init.shape), "us_init.shape") == lanes + (T, nu),
            msg="warm-start shape",
        )
    xs = stages.rollout(x_init, us_init)
    us = stages.carry(us_init)

    def scalar(v):
        return torch.tensor(v, **kw)

    def per_lane(v, dtype=dtype):
        return torch.full(lanes, v, dtype=dtype, device=device)

    mu = per_lane(params.mu)
    reg = per_lane(params.reg)
    w = per_lane(params.w if params.w is not None else 1.0 / params.mu)
    n = per_lane(params.n if params.n is not None else 1.0 / params.mu**0.1)
    threshold = scalar(params.threshold)
    eps = scalar(torch.finfo(dtype).eps)
    w_min = scalar(params.w_min) if params.w_min is not None else 10.0 * eps**0.5
    affine = method is Method.PRIMAL_DUAL_AFFINE

    def constrain_jac(jac):
        # constant-multiplier methods never grow a state-feedback term
        return jac if affine else torch.zeros_like(jac)

    mults = stages.init_mults(xs, mults_init_jac)
    mults = mults._replace(jac=constrain_jac(mults.jac))

    # --- pre-loop: derivatives → backward → forward (ddp.hpp:768-773) ---
    derivs = stages.derivatives(xs, us)
    bres = stages.backward(derivs, mults, mu, reg)
    mu = bres.mu
    fwd = stages.forward(xs, us, bres.k, bres.K, mults, mu)
    fb = al_mod.AffineMults(bres.k, bres.K, xs[..., :-1, :])
    if not reference_schedule:
        # the reference never swaps the pre-loop forward's trajectory in;
        # keeping it is ddp_tpu's documented improvement
        xs, us = fwd.xs, fwd.us

    def body(c: _Carry, active):
        """One outer iteration (update_derivatives, ddp.hpp:641-696, then
        the backward/forward pair, ddp.hpp:804-826) on every lane: the new
        carry and the iteration's history row.  A lane that finds itself
        converged keeps its iterate and schedule; a lane outside ``active``
        keeps its whole state (the caller's select)."""
        derivs = stages.derivatives(c.xs, c.us)
        mults = stages.update_origin(c.mults, c.xs)
        mults = mults._replace(jac=constrain_jac(mults.jac))
        opt_obj = stages.opt_obj(derivs, mults, c.mu)
        opt_constr = stages.opt_constr(derivs)
        # stopping uses the μ-free Lagrangian stationarity: opt_obj carries
        # μ·eqᵀeq_u terms whose float floor is μ·eps
        opt_lag = stages.opt_lag(derivs, mults)

        if reference_schedule:
            done = (opt_obj < threshold) & (opt_constr < threshold)
            gate = opt_obj < c.w
        else:
            done = (opt_lag < threshold) & (opt_constr < threshold)
            # the reference's opt_obj < w with a dtype floor, and a plateau
            # test (see SolverParams)
            plateau = (opt_obj >= 0.1 * c.opt_obj_prev) & ~c.just_changed
            gate = (opt_obj < torch.maximum(c.w, w_min)) | plateau
            if params.inner_iters_max is not None:
                gate = gate | (c.inner >= params.inner_iters_max)
        upd_success = ~done & gate & (opt_constr < c.n)
        upd_failure = ~done & gate & (opt_constr >= c.n)
        changed = upd_success | upd_failure
        measures = dict(
            it=c.it + 1, done=done, opt_lag=opt_lag, opt_constr=opt_constr, opt_obj_prev=opt_obj,
            just_changed=changed, inner=torch.where(changed, torch.ones_like(c.inner), c.inner + 1),
        )  # fmt: skip
        live = active & ~done
        if not bool(live.any()):
            # every lane converged or stopped: nothing below would be kept
            new_c = c._replace(**measures)
        else:
            # first-order AL multiplier update (ddp.hpp:680-688):
            #   p += μ (eq + eq_u·k);  p_x += μ (eq_x + eq_u·K)
            # PRIMAL uses no multiplier feedback: p += μ·eq only
            gain = torch.where(upd_success, c.mu, torch.zeros_like(c.mu))
            val_inc, jac_inc = stages.increments(derivs, c.fb, c.xs, method is not Method.PRIMAL)
            mults = stages.mult_update(mults, gain, val_inc, jac_inc, params.mult_max)
            mults = mults._replace(jac=constrain_jac(mults.jac))

            mu_new = torch.where(upd_failure, c.mu * params.mu_factor, c.mu)
            if params.mu_max is not None:
                mu_new = torch.minimum(mu_new, scalar(params.mu_max))
            if reference_schedule:
                # ddp.hpp:787-797: on success n = opt_obj with the updated
                # multipliers / μ^0.1 and w /= μ; on failure only μ grows
                n_new = c.n
                if bool(upd_success.any()):
                    n_new = torch.where(upd_success, stages.opt_obj(derivs, mults, c.mu) / c.mu**0.1, c.n)
            else:
                n_new = torch.where(
                    upd_success,
                    torch.maximum(c.n * c.mu**-0.9, threshold),
                    torch.where(upd_failure, mu_new**-0.1, c.n),
                )
            w_new = torch.where(upd_success, c.w / c.mu, c.w)

            bres = stages.backward(derivs, mults, mu_new, c.reg, live)
            fwd = stages.forward(c.xs, c.us, bres.k, bres.K, mults, bres.mu, live)
            reg = torch.where(
                fwd.step >= 0.5,
                torch.where(bres.reg / 2 < 1e-5, torch.zeros_like(bres.reg), bres.reg / 2),
                bres.reg,
            )
            stepped = c._replace(
                xs=fwd.xs, us=fwd.us, mults=mults,
                fb=al_mod.AffineMults(bres.k, bres.K, c.xs[..., :-1, :]), mu=bres.mu, reg=reg,
                w=w_new, n=n_new, step=fwd.step,
            )  # fmt: skip
            # a lane that converged keeps its iterate and schedule
            new_c = _pick(done, c, stepped)._replace(**measures)
        row = (new_c.mu, new_c.reg, new_c.w, new_c.n, new_c.step, opt_obj, opt_lag, opt_constr,
               upd_success, upd_failure, done)  # fmt: skip
        return new_c, row

    inf = per_lane(float("inf"))
    c = _Carry(
        it=per_lane(0, torch.int64), done=per_lane(False, torch.bool), xs=xs, us=us, mults=mults,
        fb=fb, mu=mu, reg=reg, w=w, n=n, opt_lag=inf, opt_constr=inf, step=fwd.step,
        opt_obj_prev=inf, just_changed=per_lane(True, torch.bool),
        inner=per_lane(1, torch.int64),  # the pre-loop backward/forward already ran
    )  # fmt: skip
    rows = []
    active = (c.it < params.max_iterations) & ~c.done
    while bool(active.any()):
        new_c, row = body(c, active)
        # a lane that stopped keeps its state and repeats its last row
        c = _pick(active, new_c, c)
        rows.append(row if not rows else tuple(_pick(active, a, b) for a, b in zip(row, rows[-1])))
        active = (c.it < params.max_iterations) & ~c.done
    hist = None
    if history:
        # the converged state repeats its row to the fixed length
        rows += [rows[-1]] * (params.max_iterations - len(rows))
        hist = SolveHistory(*(torch.stack(col, dim=-1) for col in zip(*rows)))
    return SolveResult(
        xs=stages.result(c.xs),
        us=stages.result(c.us),
        fb_k=stages.result(c.fb.val),
        fb_K=stages.result(c.fb.jac),
        mults=al_mod.AffineMults(*map(stages.result, c.mults)),
        stats=SolveStats(
            iterations=c.it,
            opt_lag=c.opt_lag,
            opt_obj=c.opt_obj_prev,
            opt_constr=c.opt_constr,
            mu=c.mu,
            reg=c.reg,
            step=c.step,
            converged=c.done,
        ),
        history=hist,
    )
