"""ddp_tpu_torch's URDF loader (``models/urdf.py``, ``utils/native.py``) and
mimic reduction (``models/reduced.py``) against ddp_tpu, f64 on the CPU:
tests/test_urdf.py's eight tests through the port, the port's UR5 held to
ddp_tpu's leaf by leaf, both parse backends giving identical records, and
the reduced gripper's dynamics held to ddp_tpu's."""

from pathlib import Path

import numpy as np
import pytest
import torch
from test_urdf import GRIPPER_URDF, MINI_URDF

import jax
import jax.numpy as jnp

from ddp_tpu.models import urdf as jurdf
from ddp_tpu.models.robots import ur5 as jur5
from ddp_tpu_torch.models import robots as trobots
from ddp_tpu_torch.models import urdf as turdf
from ddp_tpu_torch.models.reduced import ReducedModel
from ddp_tpu_torch.utils import native

jax.config.update("jax_enable_x64", True)

REPO = Path(__file__).resolve().parents[1]
UR5_PATH = str(REPO / "ddp_tpu_torch" / "models" / "assets" / "ur5.urdf")
F64 = dict(device="cpu", dtype=torch.float64)
MODEL_LEAVES = ("jp_rot", "jp_trans", "axes", "inertias", "gravity", "frame_rot",
                "frame_trans", "damping", "q_lower", "q_upper", "v_limit", "tau_limit")  # fmt: skip


def load(xml, **kw):
    return turdf.load_urdf(xml, **F64, **kw)


def test_asset_is_ddp_tpus_copy():
    """The port reads its own copy of the UR5 URDF, byte for byte ddp_tpu's."""
    ours = Path(UR5_PATH).read_bytes()
    assert ours == (REPO / "ddp_tpu" / "models" / "assets" / "ur5.urdf").read_bytes()


def test_backend_parity_ur5():
    """Native and Python parsers build identical models (≙
    test_urdf.py::test_backend_parity_ur5)."""
    m_py = load(UR5_PATH, backend="python")
    m_nat = load(UR5_PATH, backend="native")
    assert m_py.joint_types == m_nat.joint_types
    assert m_py.parents == m_nat.parents
    assert m_py.frame_names == m_nat.frame_names
    for f in MODEL_LEAVES:
        np.testing.assert_array_equal(getattr(m_py, f).numpy(), getattr(m_nat, f).numpy(), err_msg=f)
    assert np.isfinite(m_py.q_lower.numpy()).all()  # UR5 has real limits
    q = m_py.neutral_configuration()
    np.testing.assert_allclose(m_py.mass_matrix(q).numpy(), m_nat.mass_matrix(q).numpy(), atol=1e-14)


@pytest.mark.parametrize("which", ["ur5", "gripper", "mini"])
def test_native_and_etree_records_identical(which):
    """Both backends emit the same raw records (names, numbers, limit and
    mimic dicts), and the same records as ddp_tpu's etree pass."""
    import xml.etree.ElementTree as ET

    xml = {"ur5": Path(UR5_PATH).read_text(), "gripper": GRIPPER_URDF, "mini": MINI_URDF}[which]
    nat = native.parse_urdf_native(xml)
    assert nat is not None, "the native runtime did not build"
    py = turdf._records_from_etree(ET.fromstring(xml))
    ref = jurdf._records_from_etree(ET.fromstring(xml))
    for rec in (nat, ref):
        assert rec.keys() == py.keys()
        for key, val in py.items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(rec[key], val, err_msg=key)
            else:
                assert rec[key] == val, key


def test_ur5_matches_ddp_tpu_leaf_by_leaf():
    """The port's ``ur5`` against ddp_tpu's ``load_urdf``: placements, axes,
    inertias, frames and limits within 1e-12, the same tree, and the same
    mass matrix and forward dynamics at a random state."""
    tm = trobots.ur5(**F64)
    jm = jur5(dtype=jnp.float64)
    for f in MODEL_LEAVES:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=0, atol=1e-12, err_msg=f)  # fmt: skip
    assert tm.joint_types == tuple(jm.joint_types) and tm.parents == tuple(jm.parents)
    assert tm.frame_names == tuple(jm.frame_names) and tm.frame_bodies == tuple(jm.frame_bodies)
    assert tm.name == jm.name
    assert trobots.ee_frame_id(tm, "ee_link") == jur5.__globals__["ee_frame_id"](jm, "ee_link")
    rng = np.random.default_rng(3)
    q, v, tau = (rng.normal(size=6) for _ in range(3))
    np.testing.assert_allclose(tm.mass_matrix(torch.tensor(q)).numpy(),
                               np.asarray(jm.mass_matrix(jnp.asarray(q))), rtol=0, atol=1e-12)  # fmt: skip
    np.testing.assert_allclose(
        tm.forward_dynamics(*(torch.tensor(x) for x in (q, v, tau))).numpy(),
        np.asarray(jm.forward_dynamics(*(jnp.asarray(x) for x in (q, v, tau)))),
        rtol=1e-10, atol=1e-10,
    )


def test_backend_parity_mimic_gripper():
    """A mimic-bearing URDF reduces identically through both backends (≙
    test_urdf.py::test_backend_parity_mimic_gripper)."""
    g_py = load(GRIPPER_URDF, backend="python")
    g_nat = load(GRIPPER_URDF, backend="native")
    assert isinstance(g_nat, ReducedModel)
    np.testing.assert_array_equal(g_py.coupling.numpy(), g_nat.coupling.numpy())
    for f in ("q_lower", "q_upper", "v_limit", "tau_limit"):
        np.testing.assert_array_equal(getattr(g_py, f).numpy(), getattr(g_nat, f).numpy(), err_msg=f)
    q, v, tau = torch.tensor([0.3, 0.02], **F64), torch.tensor([0.5, -0.1], **F64), torch.tensor([1.0, 0.4], **F64)
    np.testing.assert_allclose(
        g_py.forward_dynamics(q, v, tau).numpy(), g_nat.forward_dynamics(q, v, tau).numpy(), atol=1e-14
    )


def test_fixed_joint_merges_inertia_and_adds_frame():
    m = load(MINI_URDF)
    assert m.nb == 1
    assert "tool" in m.frame_names
    # merged mass = 2.0 + 0.5 at the m[5,5] block of the spatial inertia
    assert abs(float(m.inertias[0, 5, 5]) - 2.5) < 1e-12
    # tool frame sits 0.8 below the joint, joint 0.5 above world
    fid = m.frame_names.index("tool")
    p = m.frame_position(fid, m.neutral_configuration())
    np.testing.assert_allclose(p.numpy(), [0.0, 0.0, -0.3], atol=1e-12)


def test_floating_base_insertion():
    m = load(MINI_URDF, root_joint="freeflyer")
    assert m.joint_types[0] == "freeflyer"
    assert m.nq == 7 + 1 and m.nv == 6 + 1
    q = m.neutral_configuration()
    assert np.isfinite(m.mass_matrix(q).numpy()).all()
    jm = jurdf.load_urdf(MINI_URDF, root_joint="freeflyer", dtype=jnp.float64)
    for f in MODEL_LEAVES:
        np.testing.assert_allclose(getattr(m, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=0, atol=1e-12, err_msg=f)  # fmt: skip


def test_pendulum_urdf_matches_closed_form():
    """The mini URDF is a gravity pendulum (≙
    test_urdf.py::test_pendulum_urdf_matches_closed_form)."""
    m = load(MINI_URDF)
    a = float(m.forward_dynamics(*(torch.tensor([x], **F64) for x in (0.3, 0.0, 0.0)))[0])
    I_tot = 0.03 + 2.0 * 0.4**2 + 1e-4 + 0.5 * 0.8**2
    torque_g = -(2.0 * 9.81 * 0.4 + 0.5 * 9.81 * 0.8) * np.sin(0.3)
    np.testing.assert_allclose(a, torque_g / I_tot, rtol=1e-10)


def test_joint_limits_parsed():
    m = load(MINI_URDF, backend="python")
    assert np.isinf(m.q_lower.numpy()).all()
    assert np.isinf(m.tau_limit.numpy()).all()
    g = load(GRIPPER_URDF, backend="python")
    np.testing.assert_allclose(g.q_lower.numpy(), [-1.0, 0.0])
    np.testing.assert_allclose(g.q_upper.numpy(), [1.5, 0.04])
    np.testing.assert_allclose(g.v_limit.numpy(), [2.0, 0.2])
    np.testing.assert_allclose(g.tau_limit.numpy(), [30.0, 10.0])


def test_mimic_reduction_dynamics():
    """≙ test_urdf.py::test_mimic_reduction_dynamics, plus the reduced
    dynamics against ddp_tpu's ReducedModel within 1e-10, batched inputs
    against one sample at a time, and no route to the full model's
    ``fd_derivatives``."""
    g = load(GRIPPER_URDF, backend="python")
    assert isinstance(g, ReducedModel)
    assert g.nq == g.nv == 2 and g.full.nv == 3
    C = g.coupling.numpy()
    np.testing.assert_allclose(C, [[1, 0], [0, 1], [0, 1]])
    q, v, tau = torch.tensor([0.3, 0.02], **F64), torch.tensor([0.5, -0.1], **F64), torch.tensor([1.0, 0.4], **F64)
    M_red = g.mass_matrix(q).numpy()
    M_full = g.full.mass_matrix(g.q_full(q)).numpy()
    np.testing.assert_allclose(M_red, C.T @ M_full @ C, atol=1e-12)
    assert np.all(np.linalg.eigvalsh(0.5 * (M_red + M_red.T)) > 0)
    a = g.forward_dynamics(q, v, tau)
    np.testing.assert_allclose(g.rnea(q, v, a).numpy(), tau.numpy(), atol=1e-9)
    qf = g.q_full(q).numpy()
    assert qf[2] == qf[1]

    jg = jurdf.load_urdf(GRIPPER_URDF, backend="python", dtype=jnp.float64)
    jq, jv, jt = (jnp.asarray(x.numpy()) for x in (q, v, tau))
    for got, ref in (
        (M_red, jg.mass_matrix(jq)),
        (a.numpy(), jg.forward_dynamics(jq, jv, jt)),
        (g.rnea(q, v, a).numpy(), jg.rnea(jq, jv, jnp.asarray(a.numpy()))),
        (g.frame_position(g.frame_names.index("tip_r"), q).numpy(),
         jg.frame_position(g.frame_names.index("tip_r"), jq)),
    ):  # fmt: skip
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-10)
    qs = torch.stack([q, 2 * q, -q])
    vs, ts = v.expand(3, 2), tau.expand(3, 2)
    a3 = g.forward_dynamics(qs, vs, ts)
    for i in range(3):
        np.testing.assert_allclose(a3[i].numpy(), g.forward_dynamics(qs[i], v, tau).numpy(), atol=1e-12)
    assert not hasattr(g, "fd_derivatives") and not hasattr(g, "joint_types")


def test_mimic_reduced_model_refuses_the_fd_kernel():
    """The derivative layer takes its generic path for a ReducedModel, and
    ``deriv="kernel"`` raises ``ValueError`` rather than routing elsewhere."""
    from ddp_tpu_torch.models.base import state_neutral
    from ddp_tpu_torch.ocp import constraints, costs, dynamics
    from ddp_tpu_torch.ocp.problem import Problem
    from ddp_tpu_torch.solver.batched import solve_batched
    from ddp_tpu_torch.solver.solve import SolverParams

    g = load(GRIPPER_URDF, backend="python")
    dyn = dynamics.euler(g, 0.01)
    assert not dyn.analytic_jacobians_ok
    con = constraints.advance_time(
        constraints.ConfigTarget(g, torch.tensor([0.2, 0.03], **F64), (4,)), dyn, times=2
    )
    problem = Problem(dyn, costs.quad_control(1.0, **F64), con, 4, second_order=False)
    with pytest.raises(ValueError, match="deriv='kernel'"):
        solve_batched(problem, SolverParams(2, 1e-8, mu=1e6), state_neutral(g)[None], deriv="kernel")


def test_mimic_reduced_model_solves():
    """End-to-end: DDP solve on the reduced gripper (ConfigTarget reach), ≙
    test_urdf.py::test_mimic_reduced_model_solves."""
    from ddp_tpu_torch import solve
    from ddp_tpu_torch.models.base import state_neutral
    from ddp_tpu_torch.ocp import constraints, costs, dynamics
    from ddp_tpu_torch.ocp.problem import Problem
    from ddp_tpu_torch.solver.solve import SolverParams

    g = load(GRIPPER_URDF, backend="python")
    H = 20
    dyn = dynamics.euler(g, 0.01)
    target = torch.tensor([0.2, 0.03], **F64)
    con = constraints.advance_time(constraints.ConfigTarget(g, target, (H,)), dyn, times=2)
    problem = Problem(dyn, costs.quad_control(1.0, **F64), con, H, second_order=False)
    res = solve(problem, SolverParams(max_iterations=30, threshold=1e-8, mu=1e6), state_neutral(g))
    assert float(res.stats.opt_constr) < 1e-6
    np.testing.assert_allclose(res.xs[-1, :2].numpy(), target.numpy(), atol=1e-5)


def test_load_urdf_backends_and_errors():
    """``backend="auto"`` takes the native records when the library builds,
    an unknown backend raises, and a URDF with no movable joint raises."""
    auto = load(UR5_PATH)
    py = load(UR5_PATH, backend="python")
    np.testing.assert_array_equal(auto.inertias.numpy(), py.inertias.numpy())
    with pytest.raises(ValueError, match="unknown URDF backend"):
        load(UR5_PATH, backend="xml")
    with pytest.raises(ValueError, match="no movable joints"):
        load('<robot name="r"><link name="a"/></robot>')
    f32 = turdf.load_urdf(UR5_PATH, device="cpu", dtype=torch.float32)
    assert f32.inertias.dtype == torch.float32 and f32.q_lower.dtype == torch.float32
