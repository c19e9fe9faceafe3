"""Parity: the port's fused line search (kernels/linesearch_flat.py, its plain
version on CPU tensors) vs ddp_tpu's parallel sweep and its Pallas kernel in
interpret mode, on numpy-seeded states handed to both packages; and the
port's solve_batched(forward="kernel") vs its own sweep and vs ddp_tpu."""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.kernels.linesearch_flat import linesearch_pallas
from ddp_tpu.solver import al as jal
from ddp_tpu.solver import batched as jbatched
from ddp_tpu.solver.solve import Method as JMethod
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu_torch.kernels import flat_problem
from ddp_tpu_torch.kernels import linesearch_flat as lsf
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import Method, SolverParams

from torch_parity_helpers import both_problems, headline_x0s, linesearch_state, t

B, H = 8, 16
# float32: the bar of tests/test_pallas_linesearch.py; float64: summation order
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-12)}


def port_linesearch(tp, s, n_cand, fn=lsf.linesearch):
    return fn(tp, t(s["xs"]), t(s["us"]), t(s["k"]), t(s["K"]), t(s["val"]), t(s["jac"]),
              t(s["mu"]), n_cand)  # fmt: skip


def jax_sweep(jp, s, n_cand):
    mults = jal.AffineMults(
        val=jnp.asarray(s["val"]), jac=jnp.asarray(s["jac"]),
        origin=jnp.asarray(s["xs"][:, :-1]),
    )  # fmt: skip
    return jax.vmap(
        lambda a, b, c, d, m_, mu_: jbatched._linesearch_sweep(jp, a, b, c, d, m_, mu_, n_cand)
    )(*(jnp.asarray(s[n]) for n in ("xs", "us", "k", "K")), mults, jnp.asarray(s["mu"]))


@pytest.mark.parametrize("n_cand", [4, 7])
@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_reference_matches_jax_sweep(np_dtype, constrained, n_cand):
    jp, tp, s = linesearch_state(B, H, np_dtype, constrained)
    xs_r, us_r, st_r = jax_sweep(jp, s, n_cand)
    xs_p, us_p, st_p = port_linesearch(tp, s, n_cand)
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))
    # lanes accept different rungs of the ladder, and one rejects them all
    assert len(np.unique(np.asarray(st_r))) >= 4 and float(np.min(np.asarray(st_r))) == 0.0
    np.testing.assert_allclose(us_p.numpy(), np.asarray(us_r), **TOL[np_dtype])
    np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_r), **TOL[np_dtype])


def test_reference_matches_jax_sweep_full_steps():
    """The unscaled gains of the backward sweep: every lane takes step 1."""
    jp, tp, s = linesearch_state(B, H, np.float32, scale_gains=False)
    xs_r, us_r, st_r = jax_sweep(jp, s, 7)
    xs_p, us_p, st_p = port_linesearch(tp, s, 7)
    assert bool((st_p == 1.0).all())
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_r))
    np.testing.assert_allclose(us_p.numpy(), np.asarray(us_r), **TOL[np.float32])
    np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_r), **TOL[np.float32])


def _vs_pallas(constrained, n_cand=7):
    jp, tp, s = linesearch_state(B, H, np.float32, constrained)
    xs_j, us_j, st_j = linesearch_pallas(
        jp, *(jnp.asarray(s[n]) for n in ("xs", "us", "k", "K", "val", "jac", "mu")),
        n_candidates=n_cand, block_b=B, interpret=True,
    )  # fmt: skip
    xs_p, us_p, st_p = port_linesearch(tp, s, n_cand)
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(us_p.numpy(), np.asarray(us_j), **TOL[np.float32])
    np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_j), **TOL[np.float32])


def test_reference_matches_pallas_interpret_unconstrained():
    _vs_pallas(constrained=False)


@pytest.mark.slow  # the constrained kernel's interpret-mode trace, as in the JAX suite
def test_reference_matches_pallas_interpret_constrained():
    _vs_pallas(constrained=True)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_rejected_lanes_keep_incumbent_bit_exact(np_dtype):
    """Anti-descent gains raise the cost of every candidate: step 0 and the
    stored trajectory, bit for bit."""
    _, tp, s = linesearch_state(B, H, np_dtype)
    s = dict(s, k=1e3 * np.ones_like(s["k"]), K=np.zeros_like(s["K"]))
    xs_p, us_p, st_p = port_linesearch(tp, s, 4)
    assert float(st_p.max()) == 0.0
    np.testing.assert_array_equal(us_p.numpy(), s["us"])
    np.testing.assert_array_equal(xs_p.numpy(), s["xs"])


def test_mixed_lanes_keep_or_move():
    """Half the lanes get anti-descent gains: they keep their trajectory bit
    for bit while the others move exactly as they do alone."""
    _, tp, s = linesearch_state(B, H, np.float64, scale_gains=False)
    bad = np.arange(B) % 2 == 0
    s2 = dict(s, k=np.where(bad[:, None, None], 1e3, s["k"]),
              K=np.where(bad[:, None, None, None], 0.0, s["K"]))  # fmt: skip
    xs_a, us_a, st_a = port_linesearch(tp, s, 5)
    xs_b, us_b, st_b = port_linesearch(tp, s2, 5)
    assert bool((st_b[bad] == 0).all()) and bool((st_b[~bad] > 0).all())
    np.testing.assert_array_equal(xs_b[bad].numpy(), s["xs"][bad])
    np.testing.assert_array_equal(us_b[~bad].numpy(), us_a[~bad].numpy())
    np.testing.assert_array_equal(xs_b[~bad].numpy(), xs_a[~bad].numpy())


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, tp, s = linesearch_state(B, H, np.float64)
    before = lsf.LAUNCHES
    got = port_linesearch(tp, s, 4)
    ref = port_linesearch(tp, s, 4, fn=lsf.linesearch_reference)
    assert lsf.LAUNCHES == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="n_candidates"):
        port_linesearch(tp, s, 0)


def test_plan_launch_passes_batch_major_inputs_as_they_stand():
    """The launch half of the wrapper (checked here on CPU tensors; it only
    checks and allocates): contiguous batch-major inputs go to the kernel as
    the very same tensors, a non-contiguous one is made contiguous once, the
    outputs are contiguous batch-major, the packed problem's mask is a tensor
    on the inputs' device; bad counts, horizons and packed problems raise."""
    _, tp, s = linesearch_state(B, H, np.float64)
    args = [t(s[n]) for n in ("xs", "us", "k", "K", "val", "jac", "mu")]
    flat = flat_problem.pack_problem(tp)
    assert isinstance(flat.mask, torch.Tensor) and flat.mask.shape == (H, 1)
    plan = lsf.plan_launch(tp, *args, 4, flat=flat)
    for given, passed in zip(args[:6] + [flat.mask, args[6]], plan.tensors[:8]):
        assert passed is given
    shapes = [tuple(x.shape) for x in plan.tensors[8:]]
    assert shapes == [(B, H + 1, 2), (B, H, 1), (B,)]
    assert all(x.is_contiguous() for x in plan.tensors[8:]) and plan.flat is flat
    K_strided = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    plan = lsf.plan_launch(tp, *args[:3], K_strided, *args[4:], 4, flat=flat)
    assert plan.tensors[3].is_contiguous() and torch.equal(plan.tensors[3], args[3])
    with pytest.raises(ValueError, match="1 to 31 candidates"):
        lsf.plan_launch(tp, *args, 32, flat=flat)
    with pytest.raises(ValueError, match="horizon"):
        lsf.plan_launch(tp, *args, 4, flat=flat._replace(horizon=H + 1))
    with pytest.raises(ValueError, match="consts"):
        lsf.plan_launch(tp, *args, 4, flat=flat._replace(consts=flat.consts.float()))


def test_solve_packs_the_problem_once(monkeypatch):
    """solve_batched(forward="kernel") packs the problem before its loop and
    hands it to every line search of the solve."""
    _, tp = both_problems(8, np.float64)
    packed, seen = [], []
    real_pack, real_ls = tbatched.pack_problem, tbatched.linesearch_flat
    monkeypatch.setattr(tbatched, "pack_problem",
                        lambda p: packed.append(real_pack(p)) or packed[-1])  # fmt: skip
    monkeypatch.setattr(tbatched, "linesearch_flat",
                        lambda *a, flat: seen.append(flat) or real_ls(*a, flat=flat))  # fmt: skip
    params = SolverParams(**dict(PARAMS, max_iterations=2))
    tbatched.solve_batched(tp, params, t(headline_x0s(2, np.float64)), forward="kernel")
    assert len(packed) == 1 and len(seen) == 3 and all(f is packed[0] for f in seen)


# ------------------------------------------------------------- whole solve

PARAMS = dict(max_iterations=4, threshold=1e-5, mu=1e4, inner_iters_max=1)


@pytest.mark.parametrize("method", ["PRIMAL", "PRIMAL_DUAL_CONSTANT", "PRIMAL_DUAL_AFFINE"])
def test_solve_forward_kernel_matches_sweep_and_jax(method):
    """solve_batched(forward="kernel", backward="kernel") in f64 at B=4: the
    port's own sweep forward and ddp_tpu's solve_batched give the same
    trajectory, multipliers and per-lane μ."""
    Bm, Hm = 4, 16
    jp, tp = both_problems(Hm, np.float64)
    x0s = headline_x0s(Bm, np.float64)
    kw = dict(n_linesearch=4, n_reg_levels=1)
    jr = jax.jit(
        lambda x: jbatched.solve_batched(jp, JParams(**PARAMS), x, method=JMethod[method], **kw)
    )(x0s)
    tk = tbatched.solve_batched(
        tp, SolverParams(**PARAMS), t(x0s), method=Method[method],
        forward="kernel", backward="kernel", **kw,
    )  # fmt: skip
    ts = tbatched.solve_batched(
        tp, SolverParams(**PARAMS), t(x0s), method=Method[method], forward="sweep", **kw
    )
    for ref_us, ref_val, ref_mu in (
        (ts.us.numpy(), ts.mults.val.numpy(), ts.mu.numpy()),
        (np.asarray(jr.us), np.asarray(jr.mults.val), np.asarray(jr.mu)),
    ):
        np.testing.assert_allclose(tk.us.numpy(), ref_us, atol=1e-9)
        scale = max(1.0, float(np.max(np.abs(ref_val))))
        assert float(np.max(np.abs(tk.mults.val.numpy() - ref_val))) <= 1e-9 * scale
        np.testing.assert_array_equal(tk.mu.numpy(), ref_mu)


def test_default_candidates_follow_jax_pallas(monkeypatch):
    """``n_linesearch=None``: forward="kernel" takes 7 candidates, as ddp_tpu's
    forward="pallas" does, and the other forwards 8; the default kernel solve
    agrees with ddp_tpu's default Pallas solve (interpret mode) in f64."""
    Bm, Hm = 4, 16
    jp, tp = both_problems(Hm, np.float64)
    x0s = headline_x0s(Bm, np.float64)
    seen = []
    for name in ("linesearch_flat", "_linesearch_sweep"):
        real = getattr(tbatched, name)
        monkeypatch.setattr(
            tbatched, name,
            lambda *a, real=real, name=name, **kw: (seen.append((name, a[-1])), real(*a, **kw))[1],
        )  # fmt: skip
    params = SolverParams(**PARAMS)
    tbatched.solve_batched(tp, params._replace(max_iterations=1), t(x0s), n_reg_levels=1)
    assert set(seen) == {("_linesearch_sweep", 8)}
    seen.clear()
    tk = tbatched.solve_batched(
        tp, params, t(x0s), forward="kernel", backward="kernel", n_reg_levels=1
    )
    assert set(seen) == {("linesearch_flat", 7)}
    jr = jax.jit(
        lambda x: jbatched.solve_batched(
            jp, JParams(**PARAMS), x, backward="pallas", forward="pallas",
            n_reg_levels=1, interpret=True,
        )  # fmt: skip
    )(x0s)
    np.testing.assert_allclose(tk.us.numpy(), np.asarray(jr.us), atol=1e-9)
    np.testing.assert_array_equal(tk.mu.numpy(), np.asarray(jr.mu))


def test_forward_kernel_refuses_problems_outside_the_class():
    from torch_parity_helpers import PANDA_READY, jax_arm_problem, torch_problem
    from ddp_tpu.models import robots as jrobots

    jarm = jrobots.panda7(dtype=jnp.float64)
    tp = torch_problem(jax_arm_problem(jarm, "ee", PANDA_READY, 4))
    x0s = torch.zeros(2, tp.nx, dtype=torch.float64)
    with pytest.raises(ValueError, match="FrameTarget on a RobotModel"):
        tbatched.solve_batched(tp, SolverParams(**PARAMS), x0s, forward="kernel")


def test_import_builds_nothing_and_imports_no_jax_no_triton():
    code = (
        "import sys\n"
        "import ddp_tpu_torch.kernels.linesearch_flat as a\n"
        "import ddp_tpu_torch.kernels.flat_solve as b\n"
        "from ddp_tpu_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'triton', 'ddp_tpu')]\n"
        "assert not bad, bad\n"
        "assert not _build._LOADED\n"
        "assert a.LAUNCHES == 0 and b.LAUNCHES == 0\n"
    )
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
