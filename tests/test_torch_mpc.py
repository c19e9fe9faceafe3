"""ddp_tpu_torch's receding-horizon MPC (``solver/mpc.py``) and checkpoints
(``utils/checkpoint.py``) against ddp_tpu, f64 on the CPU: the MPC and
checkpoint tests of tests/test_aux_subsystems.py through the port, each
replan also run by both packages from the same measured state and carry
(u0, k0, K0 and every carry leaf within 1e-9 of each array's scale)."""

import numpy as np
import pytest
import torch
from test_aux_subsystems import make_problem
from torch_parity_helpers import t, torch_problem

import jax
import jax.numpy as jnp

from ddp_tpu.models.pendulum import pendulum as jpendulum
from ddp_tpu.ocp import constraints as jcons
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdyn
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.solver import mpc as jmpc
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.utils import checkpoint as jckpt
from ddp_tpu_torch.solver import al as tal
from ddp_tpu_torch.solver import mpc
from ddp_tpu_torch.solver.solve import SolverParams
from ddp_tpu_torch.utils import checkpoint

jax.config.update("jax_enable_x64", True)

F64 = dict(dtype=torch.float64)


def state_target_problem(horizon):
    """The pendulum to [q, v] = [3.14, 0] at the horizon, advanced twice
    (test_aux_subsystems.py's StateTarget problem), in ddp_tpu."""
    model = jpendulum(1.0, 1.0, dtype=jnp.float64)
    dyn = jdyn.euler(model, 0.01)
    con = jcons.advance_time(
        jcons.StateTarget(model=model, target=jnp.asarray([3.14, 0.0]), active_ts=(horizon,)),
        dyn, times=2,
    )  # fmt: skip
    return JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64),
                    constraint=con, horizon=horizon)  # fmt: skip


def port_carry(jcarry) -> mpc.MPCCarry:
    """ddp_tpu's MPCCarry as the port's (f64 CPU tensors)."""
    return mpc.MPCCarry(*(
        None if a is None
        else tal.AffineMults(*(t(x) for x in a)) if isinstance(a, tuple) else t(a)
        for a in jcarry
    ))  # fmt: skip


def carry_leaves(carry):
    return [x for a in carry if a is not None for x in (a if isinstance(a, tuple) else (a,))]


def assert_close(got, ref, tol=1e-9, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=what)


def assert_step_matches(out, jout):
    for name in ("u0", "k0", "K0", "opt_constr"):
        assert_close(getattr(out, name).numpy(), getattr(jout, name), what=name)
    assert float(out.carry.mu) == float(jout.carry.mu)
    assert float(out.carry.reg) == float(jout.carry.reg)
    for i, (a, b) in enumerate(zip(carry_leaves(out.carry), carry_leaves(jout.carry))):
        assert_close(a.numpy(), b, what=f"carry leaf {i}")


def jax_loop(jstep, jp, x, jcarry, n, advance_plant=True):
    """ddp_tpu's replan loop; yields (x, carry, MPCStep) of every replan."""
    for _ in range(n):
        jout = jstep(x, jcarry)
        yield x, jcarry, jout
        jcarry = jout.carry
        if advance_plant:
            x = jp.dynamics(0, x, jout.u0)


# ------------------------------------------------------------------ MPC


def test_mpc_on_device_loop():
    """≙ test_mpc_on_device_loop: run_mpc's closed loop, shapes and finite
    states, and the whole loop against ddp_tpu's."""
    jp = make_problem(horizon=20)
    tp = torch_problem(jp)
    kw = dict(max_iterations=3, threshold=1e-6, mu=1e5)
    xs, us, ocs = mpc.run_mpc(tp, SolverParams(**kw), torch.zeros(2, **F64), n_steps=10)
    assert xs.shape == (11, 2) and us.shape == (10, 1) and ocs.shape == (10,)
    assert bool(torch.isfinite(xs).all())
    jxs, jus, jocs = jax.jit(lambda x: jmpc.run_mpc(jp, JParams(**kw), x, n_steps=10))(jnp.zeros(2))
    for got, ref, name in ((xs, jxs, "xs"), (us, jus, "us"), (ocs, jocs, "opt_constr")):
        assert_close(got.numpy(), ref, what=name)


def test_mpc_step_matches_ddp_tpu_replan_for_replan():
    """From the same measured state and carry, every replan of a closed loop
    (test_mpc_receding_horizon's problem, 8 replans) gives ddp_tpu's u0, k0,
    K0 and carry; the port's own loop stays on ddp_tpu's states."""
    jp = state_target_problem(30)
    tp = torch_problem(jp)
    kw = dict(max_iterations=4, threshold=1e-6, mu=1e6)
    jstep = jax.jit(jmpc.make_mpc_step(jp, JParams(**kw)))
    step = mpc.make_mpc_step(tp, SolverParams(**kw))
    carry = mpc.init_carry(tp)
    jcarry = jmpc.init_carry(jp, dtype=jnp.float64)
    for a, b in zip(carry_leaves(carry), carry_leaves(jcarry)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = torch.zeros(2, **F64)
    for jx, jc, jout in jax_loop(jstep, jp, jnp.zeros(2), jcarry, 8):
        assert_step_matches(step(t(jx), port_carry(jc)), jout)
        assert_close(x.numpy(), jx, what="closed-loop state")
        out = step(x, carry)
        carry, x = out.carry, tp.dynamics(0, x, out.u0)


@pytest.mark.slow
def test_mpc_receding_horizon():
    """≙ test_mpc_receding_horizon: 120 warm-started replans drive the
    pendulum to the target and settle it there."""
    tp = torch_problem(state_target_problem(30))
    step = mpc.make_mpc_step(tp, SolverParams(max_iterations=4, threshold=1e-6, mu=1e6))
    carry = mpc.init_carry(tp)
    x = torch.zeros(2, **F64)
    for _ in range(120):
        out = step(x, carry)
        carry, x = out.carry, tp.dynamics(0, x, out.u0)
    assert bool(torch.isfinite(x).all())
    assert abs(float(x[0]) - 3.14) < 0.02 and abs(float(x[1])) < 0.1


WARM_COLD = dict(max_iterations=3, threshold=1e-12, mu=1e4, inner_iters_max=1)


@pytest.mark.slow
def test_mpc_multiplier_warm_start_beats_cold():
    """≙ test_mpc_multiplier_warm_start_beats_cold: carrying (mults, μ, reg)
    across replans reaches a lower constraint violation at a 3-iteration
    budget than controls-only warm starts (104 replans)."""
    tp = torch_problem(state_target_problem(30))
    kw = WARM_COLD

    def run(warm_mults, n_replans, advance_plant):
        step = mpc.make_mpc_step(tp, SolverParams(**kw), warm_mults=warm_mults)
        carry = mpc.init_carry(tp)
        x = torch.zeros(2, **F64)
        ocs = []
        for _ in range(n_replans):
            out = step(x, carry)
            carry = out.carry
            if advance_plant:
                x = tp.dynamics(0, x, out.u0)
            ocs.append(float(out.opt_constr))
        return np.asarray(ocs), x

    oc_warm_s, _ = run(True, 12, advance_plant=False)
    oc_cold_s, _ = run(False, 12, advance_plant=False)
    assert np.isfinite(oc_warm_s).all()
    assert oc_warm_s[-1] < 0.1 * oc_cold_s[-1], (oc_warm_s[-1], oc_cold_s[-1])
    assert oc_cold_s[-1] > 0.5 * oc_cold_s[1]
    oc_warm, x_warm = run(True, 40, advance_plant=True)
    oc_cold, _ = run(False, 40, advance_plant=True)
    assert bool(torch.isfinite(x_warm).all()) and np.isfinite(oc_warm).all()
    tail = slice(10, None)
    assert np.median(oc_warm[tail]) < 0.8 * np.median(oc_cold[tail])
    assert oc_warm[tail].max() < 0.25 * oc_cold[tail].max()


def test_mpc_warm_and_cold_replans_match_ddp_tpu():
    """The replans of test_mpc_multiplier_warm_start_beats_cold's closed
    loops, warm and controls-only, are ddp_tpu's replan for replan."""
    jp = state_target_problem(30)
    tp = torch_problem(jp)
    kw = WARM_COLD
    for warm in (True, False):
        jstep = jax.jit(jmpc.make_mpc_step(jp, JParams(**kw), warm_mults=warm))
        step = mpc.make_mpc_step(tp, SolverParams(**kw), warm_mults=warm)
        jcarry = jmpc.init_carry(jp, dtype=jnp.float64)
        for jx, jc, jout in jax_loop(jstep, jp, jnp.zeros(2), jcarry, 4):
            assert_step_matches(step(t(jx), port_carry(jc)), jout)


def test_mpc_step_forward_seq_matches_sweep():
    """≙ test_mpc_step_forward_seq_matches_sweep: forward="seq" replans bit
    for bit as the parallel sweep does, and both as ddp_tpu's."""
    jp = make_problem(horizon=20)
    tp = torch_problem(jp)
    kw = dict(max_iterations=3, threshold=1e-10, mu=1e5, inner_iters_max=1)
    step_ref = mpc.make_mpc_step(tp, SolverParams(**kw))
    step_seq = mpc.make_mpc_step(tp, SolverParams(**kw), forward="seq")
    jstep = jax.jit(jmpc.make_mpc_step(jp, JParams(**kw), forward="seq"))
    x_a = x_b = torch.tensor([0.3, 0.0], **F64)
    c_a = c_b = mpc.init_carry(tp)
    jx, jc = jnp.asarray([0.3, 0.0]), jmpc.init_carry(jp, dtype=jnp.float64)
    for _ in range(4):
        o_a, o_b = step_ref(x_a, c_a), step_seq(x_b, c_b)
        assert torch.equal(o_a.u0, o_b.u0)
        assert torch.equal(o_a.carry.mults.val, o_b.carry.mults.val)
        jout = jstep(jx, jc)
        assert_step_matches(step_seq(t(jx), port_carry(jc)), jout)
        c_a, c_b = o_a.carry, o_b.carry
        x_a, x_b = tp.dynamics(0, x_a, o_a.u0), tp.dynamics(0, x_b, o_b.u0)
        jx, jc = jp.dynamics(0, jx, jout.u0), jout.carry


def test_mpc_carry_resumes_gate_tolerances():
    """≙ test_mpc_carry_resumes_gate_tolerances: (w, n) persist across
    replans, and both replans are ddp_tpu's."""
    jp = state_target_problem(20)
    tp = torch_problem(jp)
    kw = dict(max_iterations=6, threshold=1e-9, mu=1e6)
    params = SolverParams(**kw)
    step = mpc.make_mpc_step(tp, params)
    carry = mpc.init_carry(tp)
    assert float(carry.w) == 0.0  # cold marker
    x = torch.zeros(2, **F64)
    out = step(x, carry)
    w1, n1 = float(out.carry.w), float(out.carry.n)
    assert w1 > 0.0 and n1 > 0.0
    out2 = step(tp.dynamics(0, x, out.u0), out.carry)
    assert float(out2.carry.w) <= w1
    assert float(out2.carry.w) < 1.0 / params.mu or w1 < 1.0 / params.mu

    jstep = jax.jit(jmpc.make_mpc_step(jp, JParams(**kw)))
    for jx, jc, jout in jax_loop(jstep, jp, jnp.zeros(2), jmpc.init_carry(jp, dtype=jnp.float64), 2):
        assert_step_matches(step(t(jx), port_carry(jc)), jout)


def local_carry(carry):
    """A fleet step's carry of DTensors as this rank's plain tensors."""
    return mpc.MPCCarry(*(
        tal.AffineMults(*(m.to_local() for m in a)) if isinstance(a, tuple) else a.to_local()
        for a in carry
    ))  # fmt: skip


def test_init_batch_carry_and_deferred_fleet_step():
    """init_batch_carry's [B, …] leaves as ddp_tpu's; the fleet step at the
    same size (B = 3, H = 6) on a mesh of one gloo rank in this process:
    two replans from the same state and carry as ddp_tpu's
    ``make_batch_mpc_step`` on a one-device mesh (u0, mean_constr and every
    carry leaf within 1e-9 of each array's scale, μ and reg identical); a
    legacy carry (w and n None) replans as the zero carry does, bit for
    bit."""
    jp = make_problem(horizon=6)
    tp = torch_problem(jp)
    x0s = np.stack([[0.03 * i, 0.0] for i in range(3)])
    got = mpc.init_batch_carry(tp, 3, torch.float64, x0s=t(x0s))
    ref = jmpc.init_batch_carry(jp, 3, jnp.float64, x0s=jnp.asarray(x0s))
    for a, b in zip(carry_leaves(got), carry_leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    from ddp_tpu.parallel.mesh import make_batch_mesh
    from torch_mesh_ranks import world_of_one

    kw = dict(max_iterations=3, threshold=1e-6, mu=1e5)
    jstep = jmpc.make_batch_mpc_step(jp, JParams(**kw), make_batch_mesh(1))
    jx, jc = jnp.asarray(x0s), ref
    with world_of_one() as mesh:
        step = mpc.make_batch_mpc_step(tp, SolverParams(**kw), mesh)
        x, carry = t(x0s), got
        for _ in range(2):
            u0, carry, mean_c = step(x, carry)
            ju0, jc, jmean = jstep(jx, jc)
            assert_close(u0.to_local().numpy(), ju0, what="u0")
            assert_close(mean_c.numpy(), jmean, what="mean_constr")
            local = local_carry(carry)
            assert np.array_equal(local.mu.numpy(), np.asarray(jc.mu))
            assert np.array_equal(local.reg.numpy(), np.asarray(jc.reg))
            for i, (a, b) in enumerate(zip(carry_leaves(local), carry_leaves(jc))):
                assert_close(a.numpy(), b, what=f"carry leaf {i}")
            x, jx = tp.dynamics(0, x, u0.to_local()), jp.dynamics(0, jx, ju0)
        legacy = local._replace(w=None, n=None)
        zero = local._replace(w=torch.zeros_like(local.mu), n=torch.zeros_like(local.mu))
        (u_a, c_a, m_a), (u_b, c_b, m_b) = step(x, legacy), step(x, zero)
        assert torch.equal(u_a.to_local(), u_b.to_local()) and torch.equal(m_a, m_b)
        for a, b in zip(carry_leaves(local_carry(c_a)), carry_leaves(local_carry(c_b))):
            assert torch.equal(a, b)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_roundtrip(tmp_path):
    """≙ test_checkpoint_roundtrip, and the same file read by the other
    package: leaves in JAX's flatten order (dicts by sorted key)."""
    tree = {"us": torch.arange(6.0).reshape(3, 2), "nested": (torch.ones(4), torch.zeros((2, 2)))}
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, tree)
    like = {"us": torch.zeros(3, 2), "nested": (torch.zeros(4), torch.zeros(2, 2))}
    restored = checkpoint.load(path, like)
    assert torch.equal(restored["us"], tree["us"])
    assert all(torch.equal(a, b) for a, b in zip(restored["nested"], tree["nested"]))
    jtree = jckpt.load(path, jax.tree.map(jnp.zeros_like, {"us": jnp.zeros((3, 2)),
                                                          "nested": (jnp.zeros(4), jnp.zeros((2, 2)))}))  # fmt: skip
    np.testing.assert_array_equal(np.asarray(jtree["us"]), tree["us"].numpy())
    jckpt.save(str(tmp_path / "jax.npz"), jtree)
    again = checkpoint.load(str(tmp_path / "jax"), like)  # the suffix is added
    assert torch.equal(again["us"], tree["us"])
    checkpoint.save(str(tmp_path / "bare"), tree)
    assert (tmp_path / "bare.npz").exists()


def mpc_pair(max_iterations, mu, threshold, inner_iters_max=None):
    jp = make_problem(horizon=20)
    kw = dict(max_iterations=max_iterations, threshold=threshold, mu=mu,
              inner_iters_max=inner_iters_max)  # fmt: skip
    return (jp, jax.jit(jmpc.make_mpc_step(jp, JParams(**kw))),
            mpc.make_mpc_step(torch_problem(jp), SolverParams(**kw)))  # fmt: skip


def test_mpc_carry_checkpoint_roundtrip(tmp_path):
    """≙ test_mpc_carry_checkpoint_roundtrip: the full MPCCarry persists and
    resumes bit-identically."""
    jp, _, step = mpc_pair(2, 1e4, 1e-8)
    tp = torch_problem(jp)
    carry = mpc.init_carry(tp)
    x = torch.tensor([0.2, 0.0], **F64)
    for _ in range(3):
        out = step(x, carry)
        carry, x = out.carry, tp.dynamics(0, x, out.u0)
    path = str(tmp_path / "mpc_carry.npz")
    checkpoint.save(path, carry)
    zeros = mpc.MPCCarry(*(
        tal.AffineMults(*map(torch.zeros_like, a)) if isinstance(a, tuple) else torch.zeros_like(a)
        for a in carry
    ))  # fmt: skip
    restored = checkpoint.load(path, zeros)
    out_a, out_b = step(x, carry), step(x, restored)
    assert torch.equal(out_a.u0, out_b.u0)
    assert torch.equal(out_a.carry.mults.val, out_b.carry.mults.val)
    assert float(out_a.carry.mu) == float(out_b.carry.mu)


def test_mpc_carry_checkpoint_resume(tmp_path):
    """≙ test_mpc_carry_checkpoint_resume, across packages: ddp_tpu's loop
    checkpoints its MPCCarry mid-run; the port loads the .npz into its own
    carry and resumes bit for bit as from its own checkpoint, and each
    resumed replan is ddp_tpu's."""
    jp, jstep, step = mpc_pair(3, 1e5, 1e-10, inner_iters_max=1)
    x = jnp.asarray([0.4, 0.0])
    jcarry = jmpc.init_carry(jp, dtype=jnp.float64)
    for _ in range(4):
        jout = jstep(x, jcarry)
        jcarry, x = jout.carry, jp.dynamics(0, x, jout.u0)
    path = str(tmp_path / "mpc_carry.npz")
    jckpt.save(path, jcarry)
    like = mpc.init_carry(torch_problem(jp))
    restored = checkpoint.load(path, like)
    for a, b in zip(carry_leaves(restored), carry_leaves(jcarry)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    checkpoint.save(str(tmp_path / "port.npz"), restored)
    ours = checkpoint.load(str(tmp_path / "port.npz"), like)

    tp = torch_problem(jp)
    x_res = x_own = t(x)
    c_res, c_own = restored, ours
    for _ in range(3):
        o_res, o_own, jout = step(x_res, c_res), step(x_own, c_own), jstep(x, jcarry)
        assert torch.equal(o_res.u0, o_own.u0)
        assert_step_matches(o_res, jout)
        c_res, c_own, jcarry = o_res.carry, o_own.carry, jout.carry
        x_res, x_own = tp.dynamics(0, x_res, o_res.u0), tp.dynamics(0, x_own, o_own.u0)
        x = jp.dynamics(0, x, jout.u0)
