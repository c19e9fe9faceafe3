"""Parity of ddp_tpu_torch's rigid-body layer (ops/lie.py, models/rigid_body.py,
models/robots.py) with ddp_tpu's, f64 on the CPU: the same numpy-seeded
configurations, velocities, accelerations and torques through both packages.

Tolerance: 1e-10 (1e-9 for ``fd_derivatives``), absolute for results of order
one and scaled by the reference's largest entry above that — forward dynamics
of the arm models returns accelerations of order 1e3 (wrist inertias of 1e-3),
where 1e-10 absolute would be below f64 resolution of the solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import both_robots, t

from ddp_tpu.models import robots as jrobots
from ddp_tpu.ops import lie as jlie
from ddp_tpu_torch.models import robots as trobots
from ddp_tpu_torch.models.rigid_body import build_model
from ddp_tpu_torch.ops import lie as tlie

jax.config.update("jax_enable_x64", True)

MODELS = ["panda7", "cartpole", "acrobot", "double_pendulum", "quadrotor", "all_joints_test_model"]
B = 3


def close(got, ref, tol=1e-10):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    jm, tm = both_robots(getattr(jrobots, request.param)(dtype=jnp.float64))
    rng = np.random.default_rng(7)
    neutral = jm.neutral_configuration()
    q = np.stack(
        [np.asarray(jm.integrate(neutral, jnp.asarray(d))) for d in rng.uniform(-1, 1, (B, jm.nv))]
    )
    v, a, tau = (rng.normal(size=(B, jm.nv)) for _ in range(3))
    return jm, tm, q, v, a, tau


def test_dims_and_neutral(case):
    jm, tm, *_ = case
    assert (tm.nq, tm.nv, tm.nu, tm.nb, tm.n_frames) == (jm.nq, jm.nv, jm.nu, jm.nb, jm.n_frames)
    assert tm.frame_names == jm.frame_names and tm.joint_types == jm.joint_types
    close(tm.neutral_configuration(), jm.neutral_configuration())


def test_rnea(case):
    jm, tm, q, v, a, _ = case
    close(tm.rnea(t(q), t(v), t(a)), jax.vmap(jm.rnea)(q, v, a))
    close(tm.bias_forces(t(q), t(v)), jax.vmap(jm.bias_forces)(q, v))


def test_mass_matrix(case):
    jm, tm, q, *_ = case
    close(tm.mass_matrix(t(q)), jax.vmap(jm.mass_matrix)(q))


def test_chain_cross_checks(case):
    """The chain-recursive RNEA/CRBA agree with the world-frame defaults
    (1e-9: two algorithms, not two packages)."""
    _, tm, q, v, a, _ = case
    close(tm.rnea_chain(t(q), t(v), t(a)), tm.rnea(t(q), t(v), t(a)).numpy(), 1e-9)
    close(tm.mass_matrix_chain(t(q)), tm.mass_matrix(t(q)).numpy(), 1e-9)


def test_forward_dynamics(case):
    jm, tm, q, v, _, tau = case
    ref = jax.vmap(jm.forward_dynamics)(q, v, tau)
    close(tm.forward_dynamics(t(q), t(v), t(tau)), ref)
    close(tm.forward_dynamics_direct(t(q), t(v), t(tau)), ref)
    # the residual identity RNEA(q, v, FD(q, v, τ)) = τ
    a = tm.forward_dynamics(t(q), t(v), t(tau))
    close(tm.rnea(t(q), t(v), a), tau, 1e-9)


def test_forward_dynamics_jacfwd(case):
    """jacfwd through the direct path equals jacfwd through the JAX
    package's implicit-rule forward dynamics (1e-9, as fd_derivatives)."""
    jm, tm, q, v, _, tau = case
    from torch.func import jacfwd, vmap

    def packed_t(z, q_):
        return tm.forward_dynamics(q_, z[: tm.nv], z[tm.nv :])

    def packed_j(z, q_):
        return jm.forward_dynamics(q_, z[: jm.nv], z[jm.nv :])

    z = np.concatenate([v, tau], axis=1)
    close(vmap(jacfwd(packed_t))(t(z), t(q)), jax.vmap(jax.jacfwd(packed_j))(z, q), 1e-9)


def test_fd_derivatives(case):
    jm, tm, q, v, _, tau = case
    ref = jax.vmap(jm.fd_derivatives)(q, v, tau)
    got = tm.fd_derivatives(t(q), t(v), t(tau))
    for g, r in zip(got, ref):
        close(g, r, 1e-9)


def test_frames(case):
    jm, tm, q, *_ = case
    fid = jm.n_frames - 1
    close(tm.frame_position(fid, t(q)), jax.vmap(lambda q_: jm.frame_position(fid, q_))(q))
    close(tm.frame_jacobian(fid, t(q)), jax.vmap(lambda q_: jm.frame_jacobian(fid, q_))(q))
    R_ref, p_ref = jax.vmap(lambda q_: jm.frame_pose(fid, q_))(q)
    R, p = tm.frame_pose(fid, t(q))
    close(R, R_ref)
    close(p, p_ref)


def test_integrate_difference(case):
    jm, tm, q, v, *_ = case
    q1 = jax.vmap(jm.integrate)(q, 0.7 * v)
    close(tm.integrate(t(q), t(0.7 * v)), q1)
    close(tm.difference(t(q), t(q1)), jax.vmap(jm.difference)(q, q1))
    close(tm.difference(t(q), tm.integrate(t(q), t(0.7 * v))), 0.7 * v, 1e-9)


def test_energy(case):
    jm, tm, q, v, *_ = case
    close(tm.energy(t(q), t(v)), jax.vmap(jm.energy)(q, v))


def test_leading_batch_dims(case):
    """[2, B, …] inputs give the stacked [B, …] results; an unbatched sample
    gives that sample's row."""
    _, tm, q, v, _, tau = case
    q2, v2, tau2 = (torch.stack([t(x), t(x).flip(0)]) for x in (q, v, tau))
    a = tm.forward_dynamics(t(q), t(v), t(tau))
    a2 = tm.forward_dynamics(q2, v2, tau2)
    assert a2.shape == (2, B, tm.nv)
    close(a2[0], a.numpy(), 1e-12)
    close(a2[1], a.flip(0).numpy(), 1e-12)
    close(tm.forward_dynamics(t(q)[1], t(v)[1], t(tau)[1]), a[1].numpy(), 1e-12)
    got = tm.fd_derivatives(q2, v2, tau2)
    ref = tm.fd_derivatives(t(q), t(v), t(tau))
    for g, r in zip(got, ref):
        close(g[0], r.numpy(), 1e-12)


def test_random_configuration_is_on_the_manifold(case):
    """A seeded draw is reproducible, finite, and a tangent step of at most
    π per coordinate away from the neutral configuration."""
    _, tm, *_ = case
    q = tm.random_configuration(torch.Generator().manual_seed(3))
    assert q.shape == (tm.nq,) and bool(torch.isfinite(q).all())
    assert torch.equal(q, tm.random_configuration(torch.Generator().manual_seed(3)))
    if all(jt in ("revolute", "prismatic") for jt in tm.joint_types):
        step = tm.difference(tm.neutral_configuration(), q)
        assert float(step.abs().max()) <= np.pi and float(step.abs().max()) > 0


@pytest.mark.parametrize("name", MODELS)
def test_port_constructor_matches_jax_constructor(name):
    """The port's own constructor builds the same constants as the JAX
    package's (tests above hand the JAX leaves over instead)."""
    jm = getattr(jrobots, name)(dtype=jnp.float64)
    tm = getattr(trobots, name)(device="cpu", dtype=torch.float64)
    for field in ("jp_rot", "jp_trans", "axes", "inertias", "gravity", "frame_rot",
                  "frame_trans", "damping", "q_lower", "q_upper", "v_limit", "tau_limit"):  # fmt: skip
        np.testing.assert_allclose(
            getattr(tm, field).numpy(), np.asarray(getattr(jm, field)), rtol=0, atol=1e-15
        )
    assert tm.parents == tuple(jm.parents) and tm.frame_bodies == tuple(jm.frame_bodies)
    assert tm.name == jm.name


def test_ee_frame_id_and_deferred_models():
    """``ee_frame_id`` resolves on panda7 and on the URDF-loaded UR5 (which
    raised until the URDF loader was ported), through ``ur5`` and through
    ``load_urdf`` of the bundled file alike."""
    arm = trobots.panda7(device="cpu", dtype=torch.float64)
    assert trobots.ee_frame_id(arm, "ee") == 0
    ur5 = trobots.ur5(device="cpu", dtype=torch.float64)
    assert trobots.ee_frame_id(ur5) == ur5.frame_names.index("ee_link") == 6
    again = trobots.load_urdf(str(trobots.ASSETS / "ur5.urdf"), device="cpu", dtype=torch.float64)
    assert trobots.ee_frame_id(again, "ee_link") == 6 and again.nq == again.nv == 6


def test_build_model_limits_and_parent_order():
    joints = [
        dict(type="revolute", parent=-1, limit=dict(lower=-1.0, upper=2.0, velocity=3.0, effort=4.0)),
        dict(type="continuous", parent=0, limit=dict(lower=-1.0, velocity=5.0)),
    ]  # fmt: skip
    m = build_model(joints, device="cpu", dtype=torch.float64)
    assert m.q_lower.tolist() == [-1.0, -np.inf, -np.inf]
    assert m.q_upper.tolist() == [2.0, np.inf, np.inf]
    assert m.v_limit.tolist() == [3.0, 5.0] and m.tau_limit.tolist() == [4.0, np.inf]
    with pytest.raises(ValueError, match="parent"):
        build_model(
            [dict(type="revolute", parent=1), dict(type="revolute", parent=-1)],
            device="cpu", dtype=torch.float64,
        )  # fmt: skip


LIE_CASES = {
    "quat_mul": (jlie.quat_mul, tlie.quat_mul, (4, 4)),
    "quat_rotate": (jlie.quat_rotate, tlie.quat_rotate, (4, 3)),
    "quat_exp": (jlie.quat_exp, tlie.quat_exp, (3,)),
    "quat_log": (jlie.quat_log, tlie.quat_log, (4,)),
    "quat_to_mat": (jlie.quat_to_mat, tlie.quat_to_mat, (4,)),
    "hat": (jlie.hat, tlie.hat, (3,)),
    "so2_integrate": (jlie.so2_integrate, tlie.so2_integrate, (2, ())),
    "so2_difference": (jlie.so2_difference, tlie.so2_difference, (2, 2)),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_ops(name):
    jf, tf, widths = LIE_CASES[name]
    rng = np.random.default_rng(11)
    args = []
    for w in widths:
        x = rng.normal(size=(5,) + ((w,) if w != () else ()))
        if w in (4, 2):  # unit quaternions / (cos, sin) pairs
            x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        args.append(x)
    close(tf(*map(t, args)), jf(*map(jnp.asarray, args)), 1e-12)


def test_lie_small_angle_and_mat_to_quat():
    v = np.array([[0.0, 0.0, 0.0], [1e-6, -2e-6, 5e-7], [0.3, -1.2, 2.0]])
    close(tlie.quat_exp(t(v)), jlie.quat_exp(jnp.asarray(v)), 1e-14)
    q = np.asarray(jlie.quat_exp(jnp.asarray(v)))
    close(tlie.quat_log(t(q)), jlie.quat_log(jnp.asarray(q)), 1e-12)
    R = np.asarray(jlie.quat_to_mat(jnp.asarray(q)))
    close(tlie.mat_to_quat(t(R)), jlie.mat_to_quat(jnp.asarray(R)), 1e-12)
    close(tlie.quat_conj(t(q)), jlie.quat_conj(jnp.asarray(q)), 1e-15)
