"""ddp_tpu_torch's associative-scan Riccati backward (solver/parallel_riccati.py,
``solve_batched(backward="assoc")``) against the port's sequential sweep,
ddp_tpu's ``backward_pass_assoc`` on the same float64 inputs, PyTorch's
private associative scan and a sequential fold, on the CPU
(≙ tests/test_parallel_riccati.py)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ocp.problem import Derivs as JDerivs
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.parallel_riccati import backward_pass_assoc as jbackward_pass_assoc
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver import mpc as tmpc
from ddp_tpu_torch.solver import parallel_riccati as pr
from ddp_tpu_torch.solver.batched import solve_batched
from ddp_tpu_torch.solver.riccati import backward_sweep
from ddp_tpu_torch.solver.solve import SolverParams

from torch_parity_helpers import both_problems, headline_x0s, random_spd_derivs, t, to_jax_derivs, to_torch_derivs

F64 = dict(device="cpu", dtype=torch.float64)


def pendulum_spec(H, target=2.0):
    return dict(
        mass=1.0, length=1.0, dt=0.01, c=1.0, horizon=H, second_order=False,
        target=None if target is None else np.array([target]),
        active_ts=() if target is None else (H,), advance_times=2,
    )  # fmt: skip


def make_derivs(H=64, seed=0, with_constraint=True):
    """The port's derivatives [1, H, …] and zero multipliers along a rollout
    from x0 = 0.3·N(0, 1) and us = 0.5·N(0, 1), drawn from
    ``default_rng(seed)`` (≙ test_parallel_riccati.py's make_derivs)."""
    problem = problem_from_numpy(pendulum_spec(H, 2.0 if with_constraint else None), **F64)
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(0.3 * rng.standard_normal((1, 2)))
    us = torch.tensor(0.5 * rng.standard_normal((1, H, 1)))
    xs = problem.rollout(x0, us)
    return problem, problem.derivatives(xs, us), tal.init_multipliers(problem, xs)


def scaled_err(a, b):
    """max |a − b| over the array's largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def test_assoc_matches_sequential_unconstrained():
    _, derivs, mults = make_derivs(with_constraint=False)
    zero = torch.zeros(1, **F64)
    k_seq, K_seq, ok_seq, _ = backward_sweep(derivs, mults.val, mults.jac, zero, zero)
    k_par, K_par, ok_par = pr.backward_pass_assoc(derivs, mults.val, mults.jac, zero, zero)
    assert bool(ok_seq.all()) and bool(ok_par.all())
    np.testing.assert_allclose(k_par.numpy(), k_seq.numpy(), atol=1e-9)
    np.testing.assert_allclose(K_par.numpy(), K_seq.numpy(), atol=1e-9)


def test_assoc_matches_sequential_with_al_terms():
    """Constant and affine multiplier terms fold into the stage cost and
    still match the sequential Q-expansion."""
    _, derivs, mults = make_derivs(with_constraint=True, seed=3)
    rng = np.random.default_rng(7)
    val = torch.tensor(0.5 * rng.standard_normal(mults.val.shape))
    jac = torch.tensor(0.2 * rng.standard_normal(mults.jac.shape))
    mu, reg = torch.full((1,), 1e4, **F64), torch.zeros(1, **F64)
    k_seq, K_seq, ok_seq, _ = backward_sweep(derivs, val, jac, mu, reg)
    k_par, K_par, ok_par = pr.backward_pass_assoc(derivs, val, jac, mu, reg)
    assert bool(ok_seq.all()) and bool(ok_par.all())
    np.testing.assert_allclose(k_par.numpy(), k_seq.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(K_par.numpy(), K_seq.numpy(), rtol=1e-8, atol=1e-8)


def test_assoc_long_horizon_finite():
    """T = 1024 (11 rounds of the scan) stays finite."""
    _, derivs, mults = make_derivs(H=1024, with_constraint=False)
    zero = torch.zeros(1, **F64)
    k, K, ok = pr.backward_pass_assoc(derivs, mults.val, mults.jac, zero, zero)
    assert bool(ok.all())
    assert bool(torch.isfinite(k).all() and torch.isfinite(K).all())


@pytest.mark.parametrize("dims", [(2, 1, 1), (4, 2, 2)], ids=["n2m1e1", "n4m2e2"])
def test_assoc_matches_ddp_tpu(dims):
    """The same float64 blocks and multipliers through both packages'
    backward_pass_assoc, lane by lane in ddp_tpu: gains within 1e-10 of each
    array's largest entry, ok equal.  Lane 2's luu is negative definite, so
    U fails to factor there and ok is False in both; lane 3 runs at reg 0.5."""
    n, m, e = dims
    B, T = 4, 24
    f, pe, pex = random_spd_derivs(B, T, n, m, e, seed=5)
    f["luu"][2] = -3.0 * np.eye(m)
    mu = np.array([1e3, 1e4, 1e2, 1e3])
    reg = np.array([0.0, 0.0, 0.0, 0.5])
    k, K, ok = pr.backward_pass_assoc(to_torch_derivs(f), t(pe), t(pex), t(mu), t(reg))
    jd = to_jax_derivs(f)
    fn = jax.jit(jbackward_pass_assoc)
    for b in range(B):
        kj, Kj, okj = fn(jax.tree.map(lambda a: a[b], jd), pe[b], pex[b], mu[b], reg[b])
        assert bool(okj) == bool(ok[b]), b
        if bool(okj):
            assert scaled_err(k[b], t(kj)) <= 1e-10, b
            assert scaled_err(K[b], t(Kj)) <= 1e-10, b
    assert not bool(ok[2]) and bool(ok[[0, 1, 3]].all())


def test_assoc_batched_matches_lane_by_lane():
    """The batch-major form (B = 4) against the same lanes one at a time
    without a batch dim (other products, other roundoff)."""
    f, pe, pex = random_spd_derivs(4, 16, 2, 1, 1, seed=8)
    d = to_torch_derivs(f)
    mu, reg = t(np.array([1e2, 1e3, 1e4, 1e5])), t(np.array([0.0, 1e-3, 0.0, 0.1]))
    k, K, ok = pr.backward_pass_assoc(d, t(pe), t(pex), mu, reg)
    for b in range(4):
        kb, Kb, okb = pr.backward_pass_assoc(
            type(d)(*(x[b] for x in d)), t(pe[b]), t(pex[b]), mu[b], reg[b]
        )
        assert bool(okb) == bool(ok[b])
        assert scaled_err(k[b], kb) <= 1e-12 and scaled_err(K[b], Kb) <= 1e-12


def random_elems(N, n, seed, batch=()):
    """Random scan elements with symmetric positive semi-definite C and J."""
    rng = np.random.default_rng(seed)
    A, C, J = (torch.tensor(0.4 * rng.standard_normal(batch + (N, n, n))) for _ in range(3))
    b, eta = (torch.tensor(rng.standard_normal(batch + (N, n))) for _ in range(2))
    return pr._Elem(A, b, C @ C.mT, eta, J @ J.mT)


@pytest.mark.parametrize("N", [1, 2, 7, 33, 201])
def test_hand_scan_matches_sequential_fold(N):
    """out[t] = e_t ⊗ out[t+1], folded from the end one step at a time: the
    order of the operands (a swapped order passes an unconstrained sweep and
    fails with AL terms), at lengths that take every branch of the odd-even
    recursion."""
    elems = random_elems(N, 2, seed=N, batch=(3,))
    out = pr._reverse_scan(elems)
    acc = pr._Elem(*(x[:, -1] for x in elems))
    fold = [acc]
    for i in range(N - 2, -1, -1):
        acc = pr._compose(pr._Elem(*(x[:, i] for x in elems)), acc)
        fold.append(acc)
    fold = pr._Elem(*(torch.stack(f[::-1], dim=1) for f in zip(*fold)))
    for got, ref in zip(out, fold):
        assert scaled_err(got, ref) <= 1e-12


def test_hand_scan_matches_private_associative_scan():
    """The product path's scan against torch._higher_order_ops.associative_scan
    (a private prototype, which the port does not import): reverse=True
    gives out[t] = combine(out[t+1], e_t), so combine swaps its operands, as
    ddp_tpu's call of jax.lax.associative_scan does."""
    from torch._higher_order_ops import associative_scan

    elems = random_elems(19, 2, seed=1)
    ref = associative_scan(
        lambda a, b: tuple(pr._compose(pr._Elem(*b), pr._Elem(*a))), tuple(elems), 0,
        reverse=True, combine_mode="generic",
    )  # fmt: skip
    for got, want in zip(pr._reverse_scan(elems), ref):
        assert scaled_err(got, want) <= 1e-12
    assert "_higher_order_ops" not in inspect.getsource(pr)


def test_assoc_f32_gains_as_accurate_as_ddp_tpu_at_t200():
    """The order of the scan's compositions decides the float32 error: on
    the state of bench.py's T200 row after 8 iterations (16 lanes, f32, μ up
    to 1e9), the port's and ddp_tpu's assoc gains against the float64 sweep
    of the same inputs, per lane relative to its largest gain: the port's
    median and worst lane within 5× ddp_tpu's (recursive doubling gave 600×
    and 20,000×)."""
    H, B = 200, 16
    problem = problem_from_numpy(pendulum_spec(H, 3.14), device="cpu", dtype=torch.float32)
    x0s = t(headline_x0s(4096, np.float32)[:B])
    res = solve_batched(problem, SolverParams(8, 1e-5, mu=1e4, inner_iters_max=1), x0s,
                        n_reg_levels=1, n_linesearch=4, forward="seq")  # fmt: skip
    d = problem.derivatives(res.xs, res.us)
    args = (res.mults.val, res.mults.jac, res.mu, res.reg)
    k64, _, _, _ = backward_sweep(type(d)(*(f.double() for f in d)), *(a.double() for a in args))
    kt, _, _ = pr.backward_pass_assoc(d, *args)
    kj, _, _ = jax.jit(jax.vmap(jbackward_pass_assoc))(
        JDerivs(*(jnp.asarray(f.numpy()) for f in d)), *(jnp.asarray(a.numpy()) for a in args)
    )

    def lane_err(k):
        return (k.double() - k64).abs().amax(dim=(1, 2)) / k64.abs().amax(dim=(1, 2))

    et, ej = lane_err(kt), lane_err(t(kj))
    assert float(et.median()) <= 5 * float(ej.median()), (et.median(), ej.median())
    assert float(et.max()) <= 5 * float(ej.max()), (et.max(), ej.max())


def test_assoc_rejects_second_order():
    """Gauss-Newton only: a second_order problem raises before any work."""
    problem = problem_from_numpy(dict(pendulum_spec(8), second_order=True), **F64)

    def no_work(*a, **k):
        raise AssertionError("solve_batched rolled out before refusing")

    problem.rollout = no_work
    with pytest.raises(ValueError, match="Gauss-Newton"):
        solve_batched(problem, SolverParams(2, 1e-5, mu=1e4), torch.zeros(2, 2, **F64),
                      backward="assoc")  # fmt: skip


HEADLINE = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)
HEADLINE_KW = dict(n_reg_levels=1, n_linesearch=4)


def test_assoc_solve_matches_ddp_tpu_headline():
    """bench.py's headline at B = 8, H = 32, f64 through backward="assoc" in
    both packages: every field of the result within 1e-9 of its array's
    largest entry, identical μ and reg (reg_used is each lane's own reg)."""
    jp, tp = both_problems(32, np.float64)
    x0s = headline_x0s(8, np.float64)
    jr = jax.jit(lambda x: jbatched.solve_batched(jp, JParams(**HEADLINE), x, backward="assoc",
                                                  **HEADLINE_KW))(x0s)  # fmt: skip
    tr = solve_batched(tp, SolverParams(**HEADLINE), t(x0s), backward="assoc", **HEADLINE_KW)
    for name in ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "w", "n"):
        assert scaled_err(getattr(tr, name), t(getattr(jr, name))) <= 1e-9, name
    assert scaled_err(tr.mults.val, t(jr.mults.val)) <= 1e-9
    np.testing.assert_array_equal(tr.mu.numpy(), np.asarray(jr.mu))
    np.testing.assert_array_equal(tr.reg.numpy(), np.asarray(jr.reg))


@pytest.mark.slow
def test_solve_batched_with_assoc_backward():
    """≙ test_parallel_riccati.py::test_solve_batched_with_assoc_backward
    (slow there too): a long horizon (H = 256), 30 iterations, f64, two
    lanes: the swing-up reached and the same optimum as the sequential
    sweep.  14 s alone, 167 s beside the other files on six workers."""
    H = 256
    problem = problem_from_numpy(pendulum_spec(H, 3.14), **F64)
    params = SolverParams(max_iterations=30, threshold=1e-9, mu=1e8)
    x0s = torch.tensor([[0.0, 0.0], [0.2, 0.0]], **F64)
    res_a = solve_batched(problem, params, x0s, backward="assoc")
    res_s = solve_batched(problem, params, x0s, backward="sweep")
    np.testing.assert_allclose(res_a.xs[:, -1, 0].numpy(), 3.14, atol=1e-5)
    assert float(res_a.opt_constr.max()) < 1e-6
    np.testing.assert_allclose(res_a.us.numpy(), res_s.us.numpy(), rtol=1e-5, atol=1e-6)


def test_mpc_step_passes_assoc_through():
    """make_mpc_step(backward="assoc") replans as the sweep route does (f64,
    three replans with the carry carried: u0 within 1e-9, identical μ)."""
    problem = problem_from_numpy(pendulum_spec(16, 3.14), **F64)
    params = SolverParams(3, 1e-5, mu=1e4, inner_iters_max=1)
    out = {}
    for backward in ("assoc", "sweep"):
        step = tmpc.make_mpc_step(problem, params, backward=backward)
        carry, x, rows = tmpc.init_carry(problem), torch.tensor([0.1, 0.0], **F64), []
        for _ in range(3):
            r = step(x, carry)
            carry, x = r.carry, problem.dynamics(0, x, r.u0)
            rows.append((r.u0, r.carry.mu))
        out[backward] = rows
    for (ua, mua), (us_, mus) in zip(out["assoc"], out["sweep"]):
        assert float((ua - us_).abs().max()) <= 1e-9 * max(1.0, float(us_.abs().max()))
        assert torch.equal(mua, mus)
