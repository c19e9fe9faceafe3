"""The precision envelope as float64 (≙ ddp_tpu/solver/precise.py and the
double-float pairs of ddp_tpu/ops/twofloat.py).

ddp_tpu widens the float32 stages where finite precision binds the solver
with double-float pairs, because its TPU has no float64.  The card has
float64, so each double-float stage here is float64 arithmetic on the
float32 problem's values, rounded back to float32 where ddp_tpu keeps a
pair's hi part (the float32 value nearest the pair: what ``.to(float32)``
gives):

    ddp_tpu (double-float)                  here (float64)
    backward_sweep_tf / backward_pass_tf    the sweep / the retrying pass on
                                            float64 copies; gains, μ and reg
                                            back at μ's dtype (storage mode:
                                            the gains stay float64)
    al_costs_tf / al_cost_total_tf          al_costs of float64 copies on a
                                            float64 twin of the problem,
                                            summed in float64
    optimality_obj_tf / optimality_lag_tf   the adjoints on float64 copies
    MultsTF, update_origin_tf,              multipliers carried in float64, a
      mult_update_tf                          float32 view for float32 stages
    rollout_tf … feedback_rollout_tf        precise="storage": the iterate in
                                            float64, evaluated on the twin

``Envelope`` and ``Storage`` are ``solve``'s stages for ``precise=True`` and
``precise="storage"``; ``solve_batched`` uses ``backward_sweep`` for
``backward="tf"`` and ``al_cost_total`` for ``precise_cost=True``.
"""

from __future__ import annotations

import copy

import torch

from ddp_tpu_torch.models.base import state_difference, state_difference_jacobian
from ddp_tpu_torch.models.pendulum import Pendulum
from ddp_tpu_torch.ocp.constraints import AdvanceTime, ConfigTarget, StateTarget
from ddp_tpu_torch.ocp.costs import QuadControlCost
from ddp_tpu_torch.ocp.dynamics import EulerDynamics
from ddp_tpu_torch.solver import al as al_mod
from ddp_tpu_torch.solver import riccati
from ddp_tpu_torch.solver.rollout import forward_pass
from ddp_tpu_torch.solver.solve import Stages, _lanes

F64 = torch.float64


def wide(x):
    """A float64 copy of a tensor or of a NamedTuple of tensors."""
    if isinstance(x, torch.Tensor):
        return x.to(F64)
    return type(x)(*map(wide, x))


def twin(problem):
    """A float64 copy of ``problem``; the caller's problem keeps its dtype
    (``nn.Module.to`` converts in place)."""
    return copy.deepcopy(problem).to(F64)


def al_cost_total(twin64, xs, us, mults, mu):
    """Σ_t AL cost per trajectory in float64 (≙ al_cost_total_tf):
    ``al.al_costs`` of float64 copies of the inputs on the float64 twin of
    the problem."""
    return al_mod.al_costs(twin64, xs.to(F64), us.to(F64), wide(mults), mu.to(F64)).sum(dim=-1)


def backward_sweep(derivs, mult_val, mult_jac, mu, reg):
    """One Riccati sweep on float64 copies (≙ backward_sweep_tf), over any
    leading batch dims: (k, K, ok), the gains at μ's dtype."""
    k, K, ok, _ = riccati.backward_sweep(
        wide(derivs), wide(mult_val), wide(mult_jac), mu.to(F64), reg.to(F64)
    )
    return k.to(mu.dtype), K.to(mu.dtype), ok


def backward_pass(derivs, mult_val, mult_jac, mu, reg, max_retries: int = 24, live=None):
    """``riccati.backward_pass`` (the sweep, restarted at reg = 2·max(reg, μ)
    and 2μ while a factorization fails) on float64 copies (≙
    backward_pass_tf); gains, μ, reg and dV come back at μ's dtype (the
    escalations are exact doublings, the same values in either type)."""
    r = riccati.backward_pass(
        wide(derivs), wide(mult_val), wide(mult_jac), mu.to(F64), reg.to(F64), max_retries, live
    )
    return r._replace(
        k=r.k.to(mu.dtype), K=r.K.to(mu.dtype), mu=r.mu.to(mu.dtype),
        reg=r.reg.to(mu.dtype), dV=r.dV.to(mu.dtype),
    )  # fmt: skip


@al_mod.full_fp32_matmuls()
def update_origin(model, mults, xs):
    """Re-anchor float64 multipliers at the iterate ``xs`` (≙
    update_origin_tf in envelope mode): val += jac·d and jac = jac·J
    accumulated in float64, with the difference d and its Jacobian J taken
    at the iterate's dtype, as ddp_tpu takes them."""
    x_new = xs[..., :-1, :]
    origin = mults.origin.to(xs.dtype)
    d = state_difference(model, origin, x_new).to(F64)
    J = state_difference_jacobian(model, origin, x_new).to(F64)
    return al_mod.AffineMults(mults.val + al_mod.mv(mults.jac, d), mults.jac @ J, x_new.to(F64))


def supports_storage(problem) -> bool:
    """Whether ``solve(precise="storage")`` takes the problem: the classes
    to which ddp_tpu gives double-float hooks (``supports_tf_storage``, and
    ``supports_tf_jacobians``, which accepts the same ones): Euler dynamics
    on the pendulum, a ConfigTarget or StateTarget under any number of
    AdvanceTime, and QuadControlCost.  Under float64 any problem could be
    stored so; accepting others would be a feature ddp_tpu lacks."""
    con = problem.constraint
    while isinstance(con, AdvanceTime):
        con = con.inner
    return (
        isinstance(problem.dynamics, EulerDynamics)
        and isinstance(problem.model, Pendulum)
        and isinstance(con, (ConfigTarget, StateTarget))
        and isinstance(problem.cost, QuadControlCost)
    )


class Envelope(Stages):
    """``solve(precise=True)``: the iterate stays at the problem's dtype; the
    multipliers are carried in float64 and the float32 stages read their
    float32 view; the sweep, the adjoints and the acceptance sums run on
    float64 copies of what they read."""

    def __init__(self, problem):
        super().__init__(problem)
        self.twin = twin(problem)
        self.dtype = next(problem.buffers()).dtype

    def view(self, mults):
        """The multipliers as the float32 stages read them (ddp_tpu's hi)."""
        return al_mod.AffineMults(*(m.to(self.dtype) for m in mults))

    def init_mults(self, xs, jac_init):
        return wide(super().init_mults(xs, jac_init))

    def update_origin(self, mults, xs):
        return update_origin(self.model, mults, xs)

    def opt_obj(self, derivs, mults, mu):
        v = self.view(mults)
        return al_mod.optimality_obj(None, wide(derivs), wide(v.val), wide(v.jac), mu.to(F64)).to(self.dtype)

    def opt_lag(self, derivs, mults):
        v = self.view(mults)
        return al_mod.optimality_lag(None, wide(derivs), wide(v.val), wide(v.jac)).to(self.dtype)

    def opt_constr(self, derivs):
        return al_mod.optimality_constr(derivs).to(self.dtype)

    def mult_update(self, mults, gain, val_inc, jac_inc, mult_max):
        """(≙ mult_update_tf) the products and sums in float64; unclipped,
        as ddp_tpu's precise solve leaves ``mult_max`` unread."""
        del mult_max
        g = gain.to(F64)
        return mults._replace(val=mults.val + _lanes(g, val_inc) * val_inc.to(F64),
                              jac=mults.jac + _lanes(g, jac_inc) * jac_inc.to(F64))  # fmt: skip

    def backward(self, derivs, mults, mu, reg, live=None):
        v = self.view(mults)
        return backward_pass(derivs, v.val, v.jac, mu, reg, live=live)

    def forward(self, xs, us, k, K, mults, mu, live=None):
        v = self.view(mults)

        def total_cost(xs_, us_):
            return al_cost_total(self.twin, xs_, us_, v, mu)

        return forward_pass(self.problem, xs, us, k, K, v, mu, total_cost=total_cost, live=live)

    def result(self, x):
        return x.to(self.dtype)


class Storage(Envelope):
    """``solve(precise="storage")``: also the iterate (xs, us) and the
    multipliers at full width, in float64, with the dynamics, the constraint,
    the derivatives and the line search evaluated on the float64 twin.

    The gains stay at the iterate's width too, where ddp_tpu's storage mode
    rounds them to float32.  The affine multiplier's increment
    μ·(eq_x + eq_u·K) is a cancellation: K → −eq_x/eq_u as μ grows.  ddp_tpu
    sums it in float32 on the rounded gain, where it comes to exactly 0 late
    in the solve; summed in float64, the rounded K's own error survives it
    and puts μ·eps₃₂·‖eq_x‖ into p_x every update: on tests/test_precise.py's
    T = 60 configuration no start of 22 then reaches opt_lag < 1e-8.  Kept
    at float64, 16 do; rounded and summed in float32 as ddp_tpu does, 9;
    ddp_tpu, 14 (tests/test_torch_reference_draws.py storage_gains)."""

    def __init__(self, problem):
        if not supports_storage(problem):
            raise ValueError(
                "precise='storage' needs Euler dynamics on the pendulum, a "
                "ConfigTarget or StateTarget (under AdvanceTime) and QuadControlCost, "
                "the classes ddp_tpu stores in double-float (see "
                "solver/precise.py supports_storage)"
            )
        super().__init__(problem)
        self.model = self.twin.model

    def rollout(self, x_init, us_init):
        return self.twin.rollout(x_init.to(F64), us_init.to(F64))

    def carry(self, x):
        return x.to(F64)

    def derivatives(self, xs, us):
        return self.derivatives_of(self.twin, xs, us)

    def view(self, mults):
        return mults

    def init_mults(self, xs, jac_init):
        return al_mod.init_multipliers(self.twin, xs, jac_init=None if jac_init is None else jac_init.to(F64))

    def update_origin(self, mults, xs):
        return al_mod.update_origin(self.model, mults, xs)

    def backward(self, derivs, mults, mu, reg, live=None):
        r = riccati.backward_pass(derivs, mults.val, mults.jac, mu.to(F64), reg.to(F64), live=live)
        return r._replace(mu=r.mu.to(self.dtype), reg=r.reg.to(self.dtype), dV=r.dV.to(self.dtype))

    def forward(self, xs, us, k, K, mults, mu, live=None):
        f = forward_pass(self.twin, xs, us, k, K, mults, mu.to(F64), live=live)
        return f._replace(step=f.step.to(self.dtype))


def stages_for(problem, precise):
    """``solve``'s stages for ``precise=True`` or ``"storage"``."""
    if precise == "storage":
        return Storage(problem)
    if precise is True:
        return Envelope(problem)
    raise ValueError(f"unknown precise mode {precise!r}; have False, True, 'storage'")
