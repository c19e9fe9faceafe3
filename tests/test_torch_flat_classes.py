"""Parity over the whole flat-lane class: the port's fused line search (#4)
and one-launch whole solve (#5), their plain versions on CPU tensors, against
ddp_tpu on every pendulum problem ddp_tpu's flat kernels take — RK4, the
tracking costs, StateTarget, trajectory targets, stacks, ``every_k`` and
``in_range`` schedules, AdvanceTime layers of other dynamics — each problem
built in both packages from one numpy spec (chip_smoke.py phase 16a's
``flat_class_spec``); and the
arrive-at-rest fleet's recipe through both kernel paths of the port.
float64 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.kernels.flat_solve import solve_flat_pallas
from ddp_tpu.kernels.linesearch_flat import linesearch_pallas
from ddp_tpu.solver import al as jal
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import flat_solve
from ddp_tpu_torch.kernels import linesearch_flat as lsf
from ddp_tpu_torch.kernels.flat_problem import COSTS, pack_problem
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

from chip_smoke import FLAT_CLASSES, flat_class_spec
from chip_smoke import FS_CLASSES as ONE_STEP  # one active step: #5 takes them
from torch_parity_helpers import headline_x0s, jax_problem_from_spec, linesearch_state, t

F64 = dict(device="cpu", dtype=torch.float64)
# tests/test_pallas_linesearch.py's sizes; tests/test_flat_solve.py's case
LS_B, LS_H, N_CAND = 8, 16, 7
H, B = 6, 8
PARAMS = dict(max_iterations=3, threshold=1e-9, mu=1e4, inner_iters_max=1)
FIELDS = ("us", "xs", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(name, T):
    spec = flat_class_spec(name, T)
    return jax_problem_from_spec(spec, jnp.float64), problem_from_numpy(spec, **F64)


def within(got, ref, bar, what):
    """|got − ref| ≤ bar × the reference array's largest entry (at least 1)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.size:
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got - ref))) <= bar * scale, what


# ------------------------------------------------------ the problem as data


@pytest.mark.parametrize("name", FLAT_CLASSES)
def test_class_packs_and_its_spec_round_trips(name):
    """pack_problem takes the class; the spec read back from its buffer
    builds the problem again (both packages agree on its mask), which packs
    to the same buffer, mask and structure."""
    jp, tp = both(name, LS_H)
    flat = pack_problem(tp)
    assert flat.build == {"DYN": int(name == "rk4_tracking"), "E": tp.ne,
                          "COST": COSTS.index(flat_class_spec(name, LS_H)["cost"]["kind"])}  # fmt: skip
    np.testing.assert_array_equal(flat.mask.numpy(), np.asarray(jp.eq_mask()))
    again = pack_problem(problem_from_numpy(flat.spec(), **F64))
    assert torch.equal(again.consts, flat.consts) and again.tree == flat.tree
    assert torch.equal(again.mask, flat.mask)


# ------------------------------------------------------- #4, the line search


def ls_case(name):
    jp = jax_problem_from_spec(flat_class_spec(name, LS_H), jnp.float64)
    return linesearch_state(LS_B, LS_H, np.float64, problem=jp)


def port_linesearch(tp, s):
    return lsf.linesearch(tp, *(t(s[n]) for n in ("xs", "us", "k", "K", "val", "jac", "mu")), N_CAND)


def assert_linesearch_matches(got, ref):
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    within(got[0].numpy(), ref[0], 1e-10, "xs")
    within(got[1].numpy(), ref[1], 1e-10, "us")


@pytest.mark.parametrize("name", FLAT_CLASSES)
def test_linesearch_matches_jax_sweep(name):
    """The port's #4 against ddp_tpu's vmapped _linesearch_sweep: steps
    identical, lanes on different rungs, xs and us within 1e-10."""
    jp, tp, s = ls_case(name)
    mults = jal.AffineMults(val=jnp.asarray(s["val"]), jac=jnp.asarray(s["jac"]),
                            origin=jnp.asarray(s["xs"][:, :-1]))  # fmt: skip
    ref = jax.vmap(
        lambda a, b, c, d, m_, mu_: jbatched._linesearch_sweep(jp, a, b, c, d, m_, mu_, N_CAND)
    )(*(jnp.asarray(s[n]) for n in ("xs", "us", "k", "K")), mults, jnp.asarray(s["mu"]))
    got = port_linesearch(tp, s)
    assert_linesearch_matches(got, ref)
    assert len(np.unique(np.asarray(ref[2]))) >= 2


@pytest.mark.parametrize("name", FLAT_CLASSES)
def test_linesearch_matches_pallas_interpret(name):
    """The port's #4 against ddp_tpu's Pallas kernel in interpret mode, which
    rebuilds the problem per lane: steps identical, xs and us within 1e-10."""
    jp, tp, s = ls_case(name)
    ref = linesearch_pallas(
        jp, *(jnp.asarray(s[n]) for n in ("xs", "us", "k", "K", "val", "jac", "mu")),
        n_candidates=N_CAND, block_b=LS_B, interpret=True,
    )  # fmt: skip
    assert_linesearch_matches(port_linesearch(tp, s), ref)


# ------------------------------------------------------ #5, the whole solve


def x0s_small():
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(-0.5, 0.5, B), np.zeros(B)], axis=1)


def assert_solve_matches(got, ref, bar):
    """Every field within ``bar`` of its array's largest entry (opt_lag of
    the largest |u|); μ, reg, w and n identical."""
    u_scale = max(1.0, float(np.max(np.abs(np.asarray(ref.us)))))
    for name in FIELDS + ("mults.val", "mults.jac"):
        g, r = (np.asarray(getattr(getattr(x, "mults"), name[6:]) if name.startswith("mults.")
                           else getattr(x, name)) for x in (got, ref))  # fmt: skip
        if name == "opt_lag":
            assert float(np.max(np.abs(g - r))) <= bar * u_scale, name
        else:
            within(g, r, bar, name)
    for name in ("mu", "reg", "w", "n"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("name", ONE_STEP)
def test_flat_solve_matches_jax_solve_batched(name):
    """The port's #5 (``solve_flat`` on CPU tensors) against ddp_tpu's
    solve_batched(n_reg_levels=1, n_linesearch=8) at tests/test_flat_solve.py's
    case (H = 6, B = 8, 3 iterations)."""
    jp, tp = both(name, H)
    x0s = x0s_small()
    ref = jbatched.solve_batched(jp, JParams(**PARAMS), jnp.asarray(x0s), n_reg_levels=1, n_linesearch=8)
    got = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s))
    assert float(np.max(np.abs(np.asarray(ref.us)))) > 0  # the lanes moved
    assert_solve_matches(got, ref, 1e-9)


@pytest.mark.parametrize("name", ("trajectory", "manifold"))
def test_flat_solve_refuses_more_than_one_active_step(name):
    """Both packages' #5 take one active step and refuse more (the every_k
    schedule is active twice by T = 16)."""
    jp, tp = both(name, LS_H)
    assert len(tp.active_ts()) > 1
    with pytest.raises(ValueError, match="single-active-step"):
        solve_flat_pallas(jp, JParams(**PARAMS), jnp.asarray(x0s_small()), interpret=True)
    with pytest.raises(ValueError, match="single-active-step"):
        flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s_small()))


@pytest.mark.slow  # ddp_tpu's whole-solve kernel traces for ~20 s a class in interpret mode
@pytest.mark.parametrize("name", ONE_STEP)
def test_flat_solve_matches_pallas_interpret(name):
    """The port's #5 against ddp_tpu's own whole-solve kernel in interpret
    mode, before any multiplier update succeeds (after one, the gains'
    anchoring is a deliberate difference: ROADMAP)."""
    jp, tp = both(name, H)
    x0s = x0s_small()
    ref = solve_flat_pallas(jp, JParams(**PARAMS), jnp.asarray(x0s), interpret=True)
    got = flat_solve.solve_flat(tp, SolverParams(**PARAMS), t(x0s))
    vals = np.asarray(ref.mults.val)
    assert vals.size == 0 or float(np.max(np.abs(vals))) == 0.0  # no update succeeded
    assert_solve_matches(got, ref, 1e-9)


# ------------------------------------------- the arrive-at-rest fleet's recipe

SLICE_H, SLICE_B = 12, 8
SLICE = dict(max_iterations=8, threshold=1e-5, mu=1e4, inner_iters_max=1)


def test_arrive_at_rest_fleet_through_both_kernel_paths():
    """chip_smoke.py phase 16b's recipe at H = 12, B = 8, 8 iterations:
    solve_batched(forward="kernel", backward="kernel") (path A) and
    solve_flat (path B) against ddp_tpu's solve_batched on its sweep
    backward, within 1e-8 of each lane's largest |u|, identical μ."""
    jp, tp = both("state", SLICE_H)
    x0s = headline_x0s(SLICE_B, np.float64)
    kw = dict(n_reg_levels=1, n_linesearch=4)
    ref = jax.jit(lambda x: jbatched.solve_batched(jp, JParams(**SLICE), x, backward="sweep", **kw))(x0s)
    path_a = tbatched.solve_batched(tp, SolverParams(**SLICE), t(x0s), forward="kernel",
                                    backward="kernel", **kw)  # fmt: skip
    path_b = flat_solve.solve_flat(tp, SolverParams(**SLICE), t(x0s), n_linesearch=4)
    ref_us = np.asarray(ref.us)
    scale = np.maximum(np.abs(ref_us).max(axis=(1, 2)), 1.0)
    assert len(np.unique(np.asarray(ref.mu))) > 1 or float(np.max(np.asarray(ref.mu))) > 1e4
    for got in (path_a, path_b):
        diff = np.abs(got.us.numpy() - ref_us).max(axis=(1, 2))
        assert bool(np.all(diff <= 1e-8 * scale)), float((diff / scale).max())
        np.testing.assert_array_equal(got.mu.numpy(), np.asarray(ref.mu))
