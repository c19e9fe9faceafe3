"""The port's entry-point examples (examples/torch_pendulum_swingup.py,
torch_ur5_reach.py, torch_mpc_fleet.py) against the recipes of ddp_tpu's
examples, f64 on the CPU at a reduced size: each script's ``build()`` beside
the same recipe built in ddp_tpu, the controls of the pendulum's solve and of
the fleet's replans within 1e-8 of their scale, UR5's problem at H = 4 leaf by
leaf (its few-iteration solve against ddp_tpu is ``slow``: ddp_tpu's ``solve``
on UR5 compiles for ~30 s), and the pendulum example's printed lines at full
size (``slow``)."""

import ast
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_mesh_ranks import world_of_one
from torch_parity_helpers import jax_pendulum_problem

from ddp_tpu import Method
from ddp_tpu.models import base as jbase
from ddp_tpu.models.robots import ee_frame_id as jee_frame_id
from ddp_tpu.models.robots import ur5 as jur5
from ddp_tpu.ocp import constraints as jconstraints
from ddp_tpu.ocp import costs as jcosts
from ddp_tpu.ocp import dynamics as jdynamics
from ddp_tpu.ocp.problem import Problem as JProblem
from ddp_tpu.parallel.mesh import make_batch_mesh as jmake_batch_mesh
from ddp_tpu.solver import mpc as jmpc
from ddp_tpu.solver.solve import SolverParams as JParams
from ddp_tpu.solver.solve import solve as jsolve
from ddp_tpu_torch import solve
from ddp_tpu_torch.solver import mpc

jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = ("torch_pendulum_swingup", "torch_ur5_reach", "torch_mpc_fleet")
F64 = dict(device="cpu", dtype=torch.float64)


def load(name):
    """An example script as a module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: six pytest workers
    share the host's cores, and these solves run no slower alone on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_err(a, b):
    """max |a − b| over each lane's largest |b| (at least 1)."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape((-1,) + b.shape[-2:]), b.reshape((-1,) + b.shape[-2:])
    scale = np.maximum(np.abs(b).max(axis=(1, 2)), 1.0)
    return float((np.abs(a - b).max(axis=(1, 2)) / scale).max())


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    """Each example imports ddp_tpu_torch, torch, numpy and the standard
    library, never JAX or ddp_tpu."""
    tree = ast.parse((REPO / "examples" / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots - set(sys.stdlib_module_names) <= {"ddp_tpu_torch", "torch", "numpy"}, roots


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_without_a_card(name):
    """device="cuda" (the default) raises without a card: no quiet fall-back
    to the host."""
    with pytest.raises((AssertionError, RuntimeError)):
        load(name).build()


def pendulum_pair(horizon):
    """examples/pendulum_swingup.py's recipe at ``horizon`` in ddp_tpu (f64:
    μ = 1e8) and the port example's ``build``."""
    jp = jax_pendulum_problem(horizon, jnp.float64, second_order=True)
    jparams = JParams(max_iterations=60, threshold=1e-8, mu=1e8)
    return (jp, jparams), load("torch_pendulum_swingup").build(device="cpu", dtype=torch.float64, horizon=horizon)


def test_pendulum_build_matches_ddp_tpu():
    """The swing-up recipe at T = 40 (full DDP, μ 1e8, 60 iterations,
    threshold 1e-8, from rest): the port's controls within 1e-8 of their
    scale of ddp_tpu's, both feasible."""
    (jp, jparams), (problem, params, x0) = pendulum_pair(40)
    assert params == type(params)(*jparams) and problem.second_order and torch.equal(x0, torch.zeros(2, **F64))
    rj = jax.jit(lambda x: jsolve(jp, jparams, x, method=Method.PRIMAL_DUAL_AFFINE))(jnp.zeros(2))
    rt = solve(problem, params, x0)
    assert lane_err(rt.us, rj.us) <= 1e-8
    assert float(rt.stats.opt_constr) < 1e-8 and float(rj.stats.opt_constr) < 1e-8


def ur5_pair(horizon):
    """examples/ur5_reach.py's recipe at ``horizon`` in ddp_tpu and the port
    example's ``build``."""
    arm = jur5(dtype=jnp.float64)
    dyn = jdynamics.euler(arm, 0.01)
    fid = jee_frame_id(arm)
    q0 = arm.neutral_configuration()
    p_target = arm.frame_position(fid, arm.integrate(q0, jnp.asarray([0.2, -0.15, 0.1, 0.05, -0.1, 0.08])))
    con = jconstraints.advance_time(
        jconstraints.FrameTarget(model=arm, target=p_target, frame_id=fid, active_ts=(horizon,)), dyn, times=2
    )
    jp = JProblem(dynamics=dyn, cost=jcosts.quad_control(1.0, dtype=jnp.float64), constraint=con,
                  horizon=horizon, second_order=False)  # fmt: skip
    jrecipe = (jp, JParams(max_iterations=55, threshold=1e-8, mu=1e8), jbase.state_pack(q0, jnp.zeros(arm.nv)))
    return jrecipe, load("torch_ur5_reach").build(device="cpu", dtype=torch.float64, horizon=horizon)


def test_ur5_build_matches_ddp_tpu():
    """The reach recipe at H = 4: the same parameters, x0, constraint (a
    frame target advanced twice: frame, step, position within 1e-12), and
    the same rollout of seeded controls and end-effector position at its
    end (within 1e-12 of their scale)."""
    (jp, jparams, jx0), (problem, params, x0) = ur5_pair(4)
    assert params == type(params)(*jparams) and not problem.second_order
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    jtarget, target = jp.constraint.inner.inner, problem.constraint.inner.inner
    assert type(target).__name__ == type(jtarget).__name__ == "FrameTarget"
    assert type(problem.constraint).__name__ == type(problem.constraint.inner).__name__ == "AdvanceTime"
    assert target.frame_id == jtarget.frame_id and target.active_ts == jtarget.active_ts
    np.testing.assert_allclose(target.target.numpy(), np.asarray(jtarget.target), rtol=0, atol=1e-12)
    us = np.random.default_rng(0).standard_normal((4, 6))
    jxs = jp.rollout(jx0, jnp.asarray(us))
    xs = problem.rollout(x0, torch.tensor(us))
    assert lane_err(xs, jxs) <= 1e-12
    p_end = problem.model.frame_position(target.frame_id, xs[-1, :6])
    jp_end = jp.model.frame_position(jtarget.frame_id, jxs[-1, :6])
    np.testing.assert_allclose(p_end.numpy(), np.asarray(jp_end), rtol=0, atol=1e-12)


@pytest.mark.slow
def test_ur5_solve_matches_ddp_tpu():
    """The reach recipe at H = 4 for 4 iterations: controls within 1e-8 of
    their scale of ddp_tpu's (~35 s, most of it ddp_tpu compiling)."""
    (jp, jparams, jx0), (problem, params, x0) = ur5_pair(4)
    jparams, params = jparams._replace(max_iterations=4), params._replace(max_iterations=4)
    rj = jax.jit(lambda x: jsolve(jp, jparams, x))(jx0)
    rt = solve(problem, params, x0)
    assert lane_err(rt.us, rj.us) <= 1e-8


FLEET_B, FLEET_REPLANS = 16, 2


def test_fleet_build_matches_ddp_tpu():
    """examples/mpc_fleet.py's recipe at B = 16 (one rank): the same starts,
    and 2 replans (the plant stepped between them) whose u0 lie within 1e-8
    of their scale of ddp_tpu's and whose mean |eq| agree to 1e-8 relative.
    The port's replans run the example's route, the Riccati kernel
    (``backward="kernel"``, its plain version on the host); ddp_tpu's the
    XLA sweep, since its ``backward="pallas"`` runs on the CPU only in
    interpret mode, which its ``make_batch_mpc_step`` does not take."""
    fleet = load("torch_mpc_fleet")
    jp = jax_pendulum_problem(fleet.H, jnp.float64)
    jparams = JParams(max_iterations=6, threshold=1e-4, mu=1e4)
    jmesh = jmake_batch_mesh(1)
    sh = NamedSharding(jmesh, P("batch"))
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-0.5, 0.5, FLEET_B), np.zeros(FLEET_B)], 1)
    jstep = jmpc.make_batch_mpc_step(jp, jparams, jmesh, backward="sweep")
    jx = jax.device_put(jnp.asarray(x0), sh)
    jcarry = jmpc.init_batch_carry(jp, FLEET_B, jnp.float64, x0s=jnp.asarray(x0))
    jcarry = jax.device_put(jcarry, jax.tree.map(lambda _: sh, jcarry))
    with world_of_one() as mesh:
        problem, params, x = fleet.build(device="cpu", dtype=torch.float64, n_scenarios=FLEET_B)
        assert params == type(params)(*jparams) and not problem.second_order
        np.testing.assert_array_equal(x.numpy(), x0)
        step = mpc.make_batch_mpc_step(problem, params, mesh, backward=fleet.BACKWARD)
        carry = mpc.init_batch_carry(problem, FLEET_B, torch.float64, x0s=x)
        for _ in range(FLEET_REPLANS):
            ju0, jcarry, jmc = jstep(jx, jcarry)
            u0, carry, mc = step(x, carry)
            assert lane_err(u0.to_local()[:, None], np.asarray(ju0)[:, None]) <= 1e-8
            assert abs(float(mc) - float(jmc)) <= 1e-8 * abs(float(jmc))
            jx = jx.at[:, 0].add(0.01 * jx[:, 1])
            x = fleet.plant_step(x)
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def test_fleet_main_runs_on_the_host():
    """The fleet example's ``main`` in a world of one (its own process group
    when none exists): the line and the JSON row of examples/mpc_fleet.py,
    one replan more than twice ``n_replans``, finite u0; the group is torn
    down after."""
    fleet = load("torch_mpc_fleet")
    out_text = io.StringIO()
    with contextlib.redirect_stdout(out_text):
        out = fleet.main(device="cpu", dtype=torch.float64, per_rank=8, n_replans=1)
    lines = out_text.getvalue().splitlines()
    assert lines[0].startswith("8 scenarios on 1 device(s): ") and "mean |eq| = " in lines[0]
    row = out["row"]
    assert row["metric"] == "fleet_replan" and row["B"] == 8 and row["backend"] == "kernel" and row["card"] is None
    assert out["replans"] == 3 and bool(torch.isfinite(out["u0"]).all())
    assert not torch.distributed.is_initialized()


@pytest.mark.slow
def test_pendulum_example_prints_ddp_tpu_lines():
    """examples/pendulum_swingup.py and the port's example at full size
    (T = 200, f64): the same converged flag, final q, |eq| within 10× and
    the same trajectory lines (~1 min)."""
    spec = importlib.util.spec_from_file_location("pendulum_swingup", REPO / "examples" / "pendulum_swingup.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    texts = []
    for run in (jex.main, lambda: load("torch_pendulum_swingup").main(device="cpu", dtype=torch.float64)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        texts.append(buf.getvalue().splitlines())
    (jconv, jq, jeq, *jtraj), (conv, q, eq, *traj) = texts
    assert conv.split()[0] == jconv.split()[0] and q == jq and traj == jtraj
    assert float(eq.split()[-1]) <= 10 * float(jeq.split()[-1])
