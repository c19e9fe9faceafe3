"""Rigid-body dynamics in PyTorch: spatial algebra, Lie-group joints,
RNEA / CRBA / forward dynamics, forward kinematics and frames
(≙ ddp_tpu/models/rigid_body.py).

Every function is plain tensor code, so ``torch.func.jacfwd`` through it
supplies every derivative the solver needs.

Design notes:
- Featherstone spatial vectors, (angular, linear) ordering.
- Every method takes any number of leading batch dims: ``q`` is [..., nq],
  ``v``/``a``/``tau`` are [..., nv].  The batch is a shape, not a ``vmap``.
- World-frame Jacobian formulation: one short pose pass down the tree, then
  all-body algebra as a few batched contractions with static ancestor masks
  (``_world_quantities``/``_dynamics_core``).  The chain-recursive
  ``rnea_chain``/``mass_matrix_chain`` are kept as cross-checks.
- Forward dynamics = CRBA mass matrix + Cholesky solve, a = M⁻¹(τ − bias).
- Joint types: revolute (axis), prismatic (axis), continuous (cos/sin),
  spherical (quaternion), free-flyer, planar.

Configuration layout: per-joint blocks concatenated (order of
``joint_types``); tangent/velocity layout likewise.  Bodies are numbered so
that a parent precedes its children.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import jacfwd, vmap

from ddp_tpu_torch.ops import lie

# (nq, nv) per joint type
JOINT_DIMS = {
    "revolute": (1, 1),
    "prismatic": (1, 1),
    "continuous": (2, 1),  # unbounded revolute, (cos, sin) config
    "spherical": (4, 3),  # unit quaternion (w, x, y, z)
    "freeflyer": (7, 6),  # (x, y, z, qw, qx, qy, qz); tangent (v_lin, ω) local
    "planar": (4, 3),  # (x, y, cos, sin); tangent (vx, vy, ω) local
}


# ---------------------------------------------------------------------------
# spatial algebra (any leading batch dims)
# ---------------------------------------------------------------------------


def _block2(a, b, c, d):
    """[[a, b], [c, d]] of equally-shaped [..., r, r] blocks."""
    return torch.cat([torch.cat([a, b], dim=-1), torch.cat([c, d], dim=-1)], dim=-2)


def xmat(E: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """6×6 motion transform X for coords change A→B given rotation E (A→B)
    and translation r (origin of B in A coords): X = [[E, 0], [−E·r̂, E]]."""
    return _block2(E, torch.zeros_like(E), -E @ lie.hat(r), E)


def crm(v: torch.Tensor) -> torch.Tensor:
    """Motion cross product matrix (v ×): [[ω̂, 0], [v̂_lin, ω̂]]."""
    hw, hv = lie.hat(v[..., :3]), lie.hat(v[..., 3:])
    return _block2(hw, torch.zeros_like(hw), hv, hw)


def crf(v: torch.Tensor) -> torch.Tensor:
    """Force cross product matrix (v ×*) = −crm(v)ᵀ."""
    return -crm(v).mT


def spatial_inertia(mass, com, inertia_com) -> torch.Tensor:
    """6×6 spatial inertia about the body-frame origin from mass, CoM offset
    and rotational inertia at the CoM: [[I_c − m·ĉ·ĉ, m·ĉ], [−m·ĉ, m·1]]
    (float64, on the CPU)."""
    c = lie.hat(torch.as_tensor(np.asarray(com, dtype=np.float64)))
    m = float(mass)
    Ic = torch.as_tensor(np.asarray(inertia_com, dtype=np.float64))
    return _block2(Ic - m * (c @ c), m * c, -m * c, m * torch.eye(3, dtype=torch.float64))


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _rodrigues(K: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """I + s·K + (1−c)·K² for K = hat(unit axis) [..., 3, 3], c, s [...]."""
    I3 = torch.eye(3, dtype=K.dtype, device=K.device)
    return I3 + s[..., None, None] * K + (1.0 - c)[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# joint models: X_joint(qj) (E, r), motion subspace S, manifold ops
# ---------------------------------------------------------------------------


def _joint_transform(jtype: str, qj: torch.Tensor, axis: torch.Tensor):
    """(E, r): parent-side joint frame → child body frame transform, for
    qj [..., nq_j] and axis broadcastable to [..., 3]."""
    kw = dict(dtype=qj.dtype, device=qj.device)
    batch = qj.shape[:-1]
    z3 = torch.zeros(batch + (3,), **kw)
    if jtype == "revolute":
        return _rodrigues(lie.hat(axis), torch.cos(qj[..., 0]), torch.sin(qj[..., 0])).mT, z3
    if jtype == "continuous":
        return _rodrigues(lie.hat(axis), qj[..., 0], qj[..., 1]).mT, z3
    if jtype == "prismatic":
        return torch.eye(3, **kw).expand(batch + (3, 3)), qj[..., :1] * axis
    if jtype == "spherical":
        return lie.quat_to_mat(qj).mT, z3
    if jtype == "freeflyer":
        return lie.quat_to_mat(qj[..., 3:]).mT, qj[..., :3]
    if jtype == "planar":
        x, y, c, s = qj.unbind(-1)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack(
            [
                torch.stack([c, -s, zero], -1),
                torch.stack([s, c, zero], -1),
                torch.stack([zero, zero, one], -1),
            ],
            dim=-2,
        )
        return R.mT, torch.stack([x, y, zero], dim=-1)
    raise ValueError(f"unknown joint type {jtype}")


def _joint_subspace(jtype: str, axis: np.ndarray) -> np.ndarray:
    """6×nv_j motion subspace S in child coordinates (constant in q)."""
    z3 = np.zeros(3)
    I3, Z3 = np.eye(3), np.zeros((3, 3))
    if jtype in ("revolute", "continuous"):
        return np.concatenate([axis, z3])[:, None]
    if jtype == "prismatic":
        return np.concatenate([z3, axis])[:, None]
    if jtype == "spherical":
        return np.concatenate([I3, Z3], axis=0)
    if jtype == "freeflyer":
        # tangent coords (v_lin_local, ω_local) → spatial (ω, v)
        return np.block([[Z3, I3], [I3, Z3]])
    if jtype == "planar":
        S = np.zeros((6, 3))  # tangent coords (vx, vy, ω) local
        S[2, 2] = S[3, 0] = S[4, 1] = 1.0
        return S
    raise ValueError(f"unknown joint type {jtype}")


def _joint_integrate(jtype: str, qj: torch.Tensor, vj: torch.Tensor) -> torch.Tensor:
    if jtype in ("revolute", "prismatic"):
        return qj + vj
    if jtype == "continuous":
        return lie.so2_integrate(qj, vj[..., 0])
    if jtype == "spherical":
        return lie.quat_mul(qj, lie.quat_exp(vj))
    if jtype == "freeflyer":
        p, quat = qj[..., :3], qj[..., 3:]
        dp, dw = vj[..., :3], vj[..., 3:]
        # translation increment expressed in the local (child) frame
        p_new = p + lie.quat_rotate(quat, dp)
        return torch.cat([p_new, lie.quat_mul(quat, lie.quat_exp(dw))], dim=-1)
    if jtype == "planar":
        x, y, c, s = qj[..., 0], qj[..., 1], qj[..., 2], qj[..., 3]
        dx, dy, dth = vj[..., 0], vj[..., 1], vj[..., 2]
        x_new = x + c * dx - s * dy
        y_new = y + s * dx + c * dy
        cs_new = lie.so2_integrate(qj[..., 2:], dth)
        return torch.cat([torch.stack([x_new, y_new], dim=-1), cs_new], dim=-1)
    raise ValueError(jtype)


def _joint_difference(jtype: str, qj0: torch.Tensor, qj1: torch.Tensor) -> torch.Tensor:
    if jtype in ("revolute", "prismatic"):
        return qj1 - qj0
    if jtype == "continuous":
        return lie.so2_difference(qj0, qj1)[..., None]
    if jtype == "spherical":
        return lie.quat_log(lie.quat_mul(lie.quat_conj(qj0), qj1))
    if jtype == "freeflyer":
        p0, quat0 = qj0[..., :3], qj0[..., 3:]
        p1, quat1 = qj1[..., :3], qj1[..., 3:]
        dp = lie.quat_rotate(lie.quat_conj(quat0), p1 - p0)
        dw = lie.quat_log(lie.quat_mul(lie.quat_conj(quat0), quat1))
        return torch.cat([dp, dw], dim=-1)
    if jtype == "planar":
        c0, s0 = qj0[..., 2], qj0[..., 3]
        dxy_world = qj1[..., :2] - qj0[..., :2]
        dx = c0 * dxy_world[..., 0] + s0 * dxy_world[..., 1]
        dy = -s0 * dxy_world[..., 0] + c0 * dxy_world[..., 1]
        dth = lie.so2_difference(qj0[..., 2:], qj1[..., 2:])
        return torch.stack([dx, dy, dth], dim=-1)
    raise ValueError(jtype)


def _joint_neutral(jtype: str) -> np.ndarray:
    if jtype in ("revolute", "prismatic"):
        return np.zeros(1)
    if jtype == "continuous":
        return np.array([1.0, 0.0])
    if jtype == "spherical":
        return np.array([1.0, 0.0, 0.0, 0.0])
    if jtype == "freeflyer":
        return np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    if jtype == "planar":
        return np.array([0.0, 0.0, 1.0, 0.0])
    raise ValueError(jtype)


def _slices(joint_types, which: int):
    out, o = [], 0
    for t in joint_types:
        n = JOINT_DIMS[t][which]
        out.append(slice(o, o + n))
        o += n
    return out


def _batched_jacfwd(fn, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """d fn(x, *rest)/dx with the leading dims of x (and of every ``rest``,
    broadcast to them) treated as batch: [..., out, in]."""
    batch = torch.broadcast_shapes(x.shape[:-1], *(r.shape[:-1] for r in rest))
    flat = [
        a.expand(batch + a.shape[-1:]).reshape((-1,) + a.shape[-1:]) for a in (x, *rest)
    ]
    J = vmap(jacfwd(fn))(*flat)
    return J.reshape(batch + J.shape[-2:])


# ---------------------------------------------------------------------------
# robot model
# ---------------------------------------------------------------------------


class RobotModel(nn.Module):
    """Articulated rigid-body model; constants are buffers, the tree
    (``joint_types``, ``parents``, frames) is static Python metadata."""

    def __init__(
        self,
        *,
        jp_rot: torch.Tensor,  # [nb, 3, 3] joint placement rotation (parent→joint)
        jp_trans: torch.Tensor,  # [nb, 3]   joint placement translation
        axes: torch.Tensor,  # [nb, 3]   joint axis (revolute/prismatic/continuous)
        inertias: torch.Tensor,  # [nb, 6, 6] spatial inertia in body frame
        gravity: torch.Tensor,  # [3]
        frame_rot: torch.Tensor,  # [nf, 3, 3] frame placement on its body
        frame_trans: torch.Tensor,  # [nf, 3]
        damping: torch.Tensor,  # [nv] viscous joint damping
        joint_types: tuple,
        parents: tuple,
        frame_bodies: tuple = (),
        frame_names: tuple = (),
        name: str = "robot",
        # joint limits: model metadata for callers (box penalties, sampling,
        # validation); the equality-constrained solver does not enforce them.
        # Unlimited joints hold ±inf / inf; None on models that never set them
        q_lower: torch.Tensor | None = None,  # [nq]
        q_upper: torch.Tensor | None = None,  # [nq]
        v_limit: torch.Tensor | None = None,  # [nv]
        tau_limit: torch.Tensor | None = None,  # [nv]
    ):
        super().__init__()
        self.joint_types = tuple(joint_types)
        self.parents = tuple(int(p) for p in parents)
        self.frame_bodies = tuple(int(b) for b in frame_bodies)
        self.frame_names = tuple(frame_names)
        self.name = name
        if any(p >= i for i, p in enumerate(self.parents)):
            raise ValueError(f"a parent must precede its children; got parents={self.parents}")
        for key, val in dict(
            jp_rot=jp_rot, jp_trans=jp_trans, axes=axes, inertias=inertias,
            gravity=gravity, frame_rot=frame_rot, frame_trans=frame_trans,
            damping=damping, q_lower=q_lower, q_upper=q_upper, v_limit=v_limit,
            tau_limit=tau_limit,
        ).items():  # fmt: skip
            self.register_buffer(key, val)

        # static layout, and the constants derived from it
        self._qsl = _slices(self.joint_types, 0)
        self._vsl = _slices(self.joint_types, 1)
        nb, nv = self.nb, self.nv
        colj = [j for j, t in enumerate(self.joint_types) for _ in range(JOINT_DIMS[t][1])]
        anc = np.zeros((nb, nb))
        for i in range(nb):
            j = i
            while j >= 0:
                anc[i, j] = 1.0
                j = self.parents[j]
        S_blk = np.zeros((nb, 6, nv))
        axes_np = axes.detach().cpu().numpy().astype(np.float64)
        for i, t in enumerate(self.joint_types):
            S_blk[i][:, self._vsl[i]] = _joint_subspace(t, axes_np[i])
        kw = dict(dtype=inertias.dtype, device=inertias.device)
        # [nb, nv] 0/1: column c is on the chain root→body i
        self.register_buffer("_anc_mask", torch.tensor(anc[:, colj], **kw), persistent=False)
        # [nb, 6, nv]: body i's joint subspace (body coords) in its own columns
        self.register_buffer("_S_blk", torch.tensor(S_blk, **kw), persistent=False)
        # tangent column → owning joint
        self.register_buffer(
            "_col_joint", torch.tensor(colj, dtype=torch.long, device=kw["device"]),
            persistent=False,
        )  # fmt: skip

    # ---- dims (static) ----
    @property
    def nb(self) -> int:
        return len(self.joint_types)

    @property
    def nq(self) -> int:
        return sum(JOINT_DIMS[t][0] for t in self.joint_types)

    @property
    def nv(self) -> int:
        return sum(JOINT_DIMS[t][1] for t in self.joint_types)

    @property
    def nu(self) -> int:
        return self.nv

    @property
    def dtype(self) -> torch.dtype:
        return self.inertias.dtype

    @property
    def device(self) -> torch.device:
        return self.inertias.device

    # ---- configuration manifold ----
    def neutral_configuration(self) -> torch.Tensor:
        return torch.tensor(
            np.concatenate([_joint_neutral(t) for t in self.joint_types]),
            dtype=self.dtype, device=self.device,
        )  # fmt: skip

    def random_configuration(self, generator: torch.Generator) -> torch.Tensor:
        """Uniform tangent perturbation in (−π, π) of the neutral
        configuration, drawn from an explicit generator (on its device)."""
        u = torch.rand(self.nv, generator=generator, dtype=self.dtype, device=generator.device)
        v = (2.0 * u - 1.0).to(self.device) * torch.pi
        return self.integrate(self.neutral_configuration(), v)

    def integrate(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        if all(t in ("revolute", "prismatic") for t in self.joint_types):
            return q + dq
        parts = [
            _joint_integrate(t, q[..., qs], dq[..., vs])
            for t, qs, vs in zip(self.joint_types, self._qsl, self._vsl)
        ]
        return torch.cat(parts, dim=-1)

    def difference(self, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
        if all(t in ("revolute", "prismatic") for t in self.joint_types):
            return q1 - q0
        parts = [
            _joint_difference(t, q0[..., qs], q1[..., qs])
            for t, qs in zip(self.joint_types, self._qsl)
        ]
        return torch.cat(parts, dim=-1)

    # ---- kinematics ----
    def _joint_E_r(self, q: torch.Tensor):
        """Parent body → child body (E [..., nb, 3, 3], r [..., nb, 3]): the
        joint transforms, same-type joints evaluated in one batched call,
        composed with the fixed placements: E = Ej·Ep, r = rp + Epᵀ·rj."""
        groups: dict[str, list[int]] = {}
        for i, t in enumerate(self.joint_types):
            groups.setdefault(t, []).append(i)
        E_l, r_l = [None] * self.nb, [None] * self.nb
        for t, idxs in groups.items():
            qj = torch.stack([q[..., self._qsl[i]] for i in idxs], dim=-2)
            E, r = _joint_transform(t, qj, self.axes[idxs])
            for k, i in enumerate(idxs):
                E_l[i], r_l[i] = E[..., k, :, :], r[..., k, :]
        Ej, rj = torch.stack(E_l, dim=-3), torch.stack(r_l, dim=-2)
        return Ej @ self.jp_rot, self.jp_trans + _mv(self.jp_rot.mT, rj)

    def body_poses(self, q: torch.Tensor):
        """World pose (R_wb [..., 3, 3], p_wb [..., 3]) of every body frame,
        as two lists over the bodies."""
        E, r = self._joint_E_r(q)
        ET = E.mT
        Rs, ps = [], []
        for i, p in enumerate(self.parents):
            if p < 0:
                R_w, p_w = ET[..., i, :, :], r[..., i, :]
            else:
                R_w = Rs[p] @ ET[..., i, :, :]
                p_w = _mv(Rs[p], r[..., i, :]) + ps[p]
            Rs.append(R_w)
            ps.append(p_w)
        return Rs, ps

    @property
    def n_frames(self) -> int:
        return len(self.frame_bodies)

    def frame_name(self, i: int) -> str:
        return self.frame_names[i]

    def frame_pose(self, frame_id: int, q: torch.Tensor):
        """World pose of an operational frame."""
        Rs, ps = self.body_poses(q)
        b = self.frame_bodies[frame_id]
        R = Rs[b] @ self.frame_rot[frame_id]
        p = _mv(Rs[b], self.frame_trans[frame_id]) + ps[b]
        return R, p

    def frame_position(self, frame_id: int, q: torch.Tensor) -> torch.Tensor:
        return self.frame_pose(frame_id, q)[1]

    def frame_jacobian(self, frame_id: int, q: torch.Tensor) -> torch.Tensor:
        """[..., 3, nv] Jacobian of the frame position w.r.t. a tangent
        perturbation of q — one jacfwd per sample, no hand algebra."""
        zero = torch.zeros(q.shape[:-1] + (self.nv,), dtype=q.dtype, device=q.device)
        return _batched_jacfwd(
            lambda e, q_: self.frame_position(frame_id, self.integrate(q_, e)), zero, q
        )

    # ---- world-frame batched kinematics ----
    #
    #   J_i = ancestor-masked world joint subspaces        [nb, 6, nv]
    #   M   = Σ_i J_iᵀ I_i^w J_i          (one einsum)
    #   v_i = J_i q̇;  a_i = Σ_anc (S_c q̈_c + v_c × S_c q̇_c) − g
    #   f_i = I_i^w a_i + v_i ×* I_i^w v_i;   τ = Σ_i J_iᵀ f_i

    def _world_quantities(self, q: torch.Tensor):
        """Poses + world joint subspaces + world spatial inertias.

        Returns (S_all [..., 6, nv] world-frame joint subspace columns,
                 Jw [..., nb, 6, nv] ancestor-masked body Jacobians,
                 Iw [..., nb, 6, 6] world-frame spatial inertias,
                 Rs [..., nb, 3, 3], ps [..., nb, 3])."""
        Rs_l, ps_l = self.body_poses(q)
        Rs, ps = torch.stack(Rs_l, dim=-3), torch.stack(ps_l, dim=-2)
        Z = torch.zeros_like(Rs)
        pR = lie.hat(ps) @ Rs
        Rt = Rs.mT
        # world-frame joint subspaces: X_wb @ S with X_wb = [[R, 0], [p̂R, R]]
        X_wb = _block2(Rs, Z, pR, Rs)
        S_all = torch.einsum("...bst,btn->...sn", X_wb, self._S_blk)
        Jw = S_all[..., None, :, :] * self._anc_mask[:, None, :]
        # I_w = X_bwᵀ I_b X_bw with X_bw = [[Rᵀ, 0], [−Rᵀp̂, Rᵀ]], −Rᵀp̂ = (p̂R)ᵀ
        X_bw = _block2(Rt, Z, pR.mT, Rt)
        Iw = X_bw.mT @ self.inertias @ X_bw
        return S_all, Jw, Iw, Rs, ps

    @staticmethod
    def _mass_from(Jw, Iw):
        return torch.einsum("...bsn,...bst,...btm->...nm", Jw, Iw, Jw)

    def _dynamics_core(self, q, v, a, wq=None):
        """Generalized forces τ(q, v, a) (world-frame RNEA).

        ``wq``: optional precomputed _world_quantities(q) so callers doing
        both M(q) and bias(q, v) pay for one kinematics pass."""
        S_all, Jw, Iw, _, _ = wq if wq is not None else self._world_quantities(q)
        vb = torch.einsum("...bsn,...n->...bs", Jw, v)  # body spatial velocities
        # per-column bias: ψ_c = v_{body(c)} × (S_c q̇_c)
        Svd = S_all * v[..., None, :]  # [..., 6, nv]
        v_col = vb.index_select(-2, self._col_joint)  # [..., nv, 6]
        psi = torch.einsum("...cst,...tc->...cs", crm(v_col), Svd)  # [..., nv, 6]
        Sqdd = (S_all * a[..., None, :]).mT  # [..., nv, 6]
        a0 = torch.cat([torch.zeros_like(self.gravity), -self.gravity])
        ab = torch.einsum("ic,...cs->...is", self._anc_mask, psi + Sqdd) + a0
        Ivb = _mv(Iw, vb)
        # v ×* (Iv) = −crm(v)ᵀ (Iv)
        f = _mv(Iw, ab) - _mv(crm(vb).mT, Ivb)
        tau = torch.einsum("...bsn,...bs->...n", Jw, f)
        return tau + self.damping * v

    # ---- dynamics ----
    def rnea(self, q, v, a) -> torch.Tensor:
        """Inverse dynamics τ(q, v, a), gravity included."""
        return self._dynamics_core(q, v, a)

    def mass_matrix(self, q) -> torch.Tensor:
        """M(q) = Σ_i J_iᵀ I_i^w J_i — one contraction."""
        _, Jw, Iw, _, _ = self._world_quantities(q)
        return self._mass_from(Jw, Iw)

    def _joint_X_S(self, q):
        """Per-body parent→body 6×6 transforms and motion subspaces (body
        coordinates), as two lists over the bodies."""
        E, r = self._joint_E_r(q)
        X = xmat(E, r)
        Xs = [X[..., i, :, :] for i in range(self.nb)]
        Ss = [self._S_blk[i][:, self._vsl[i]] for i in range(self.nb)]
        return Xs, Ss

    def rnea_chain(self, q, v, a) -> torch.Tensor:
        """Recursive Newton-Euler inverse dynamics τ(q, v, a), gravity
        included (chain-recursive cross-check of ``rnea``)."""
        Xs, Ss = self._joint_X_S(q)
        nb = self.nb
        a0 = torch.cat([torch.zeros_like(self.gravity), -self.gravity])
        vel, acc, f = [None] * nb, [None] * nb, [None] * nb
        for i in range(nb):
            p = self.parents[i]
            vj = _mv(Ss[i], v[..., self._vsl[i]])
            aj = _mv(Ss[i], a[..., self._vsl[i]])
            if p < 0:
                vel[i] = vj
                acc[i] = _mv(Xs[i], a0) + aj + _mv(crm(vel[i]), vj)
            else:
                vel[i] = _mv(Xs[i], vel[p]) + vj
                acc[i] = _mv(Xs[i], acc[p]) + aj + _mv(crm(vel[i]), vj)
            I = self.inertias[i]
            f[i] = _mv(I, acc[i]) + _mv(crf(vel[i]), _mv(I, vel[i]))
        tau = [None] * nb
        for i in reversed(range(nb)):
            tau[i] = _mv(Ss[i].mT, f[i])
            p = self.parents[i]
            if p >= 0:
                f[p] = f[p] + _mv(Xs[i].mT, f[i])
        return torch.cat(tau, dim=-1) + self.damping * v

    def mass_matrix_chain(self, q) -> torch.Tensor:
        """Composite-rigid-body algorithm: M(q) [..., nv, nv]
        (chain-recursive cross-check of ``mass_matrix``)."""
        Xs, Ss = self._joint_X_S(q)
        nb = self.nb
        batch = q.shape[:-1]
        Ic = [self.inertias[i].expand(batch + (6, 6)) for i in range(nb)]
        blocks = {}
        for i in reversed(range(nb)):
            p = self.parents[i]
            if p >= 0:
                Ic[p] = Ic[p] + Xs[i].mT @ Ic[i] @ Xs[i]
            F = Ic[i] @ Ss[i]  # [..., 6, nv_i]
            blocks[i, i] = Ss[i].mT @ F
            j = i
            while self.parents[j] >= 0:
                F = Xs[j].mT @ F
                j = self.parents[j]
                blocks[j, i] = Ss[j].mT @ F
                blocks[i, j] = blocks[j, i].mT
        nvj = [JOINT_DIMS[t][1] for t in self.joint_types]
        kw = dict(dtype=q.dtype, device=q.device)
        rows = [
            torch.cat(
                [
                    blocks.get((i, j), torch.zeros(batch + (nvj[i], nvj[j]), **kw))
                    for j in range(nb)
                ],
                dim=-1,
            )
            for i in range(nb)
        ]
        return torch.cat(rows, dim=-2)

    def bias_forces(self, q, v) -> torch.Tensor:
        """Coriolis/centrifugal + gravity torques: C(q, v) = RNEA(q, v, 0)."""
        return self.rnea(q, v, torch.zeros_like(v))

    def _factor_and_solve(self, q, v, tau):
        """One kinematics pass, one Cholesky: (chol of M, a = M⁻¹(τ − bias)).
        Sub-f32 dtypes (bf16) factor in f32.  A non-PD or non-finite M gives
        non-finite results and never raises."""
        wq = self._world_quantities(q)
        _, Jw, Iw, _, _ = wq
        M = self._mass_from(Jw, Iw)
        bias = self._dynamics_core(q, v, torch.zeros_like(v), wq=wq)
        solve_dtype = torch.promote_types(q.dtype, torch.float32)
        chol, _ = torch.linalg.cholesky_ex(M.to(solve_dtype))
        rhs = (tau - bias).to(solve_dtype)
        a = torch.cholesky_solve(rhs[..., None], chol)[..., 0].to(q.dtype)
        return chol, a

    def forward_dynamics_direct(self, q, v, tau) -> torch.Tensor:
        """a = M(q)⁻¹ (τ − C(q, v)) via Cholesky; one shared kinematics pass
        feeds both the mass matrix and the bias forces, and forward- or
        reverse-mode AD flows through every op."""
        return self._factor_and_solve(q, v, tau)[1]

    # The JAX package wraps the direct path in a custom JVP (the implicit
    # rule da = M⁻¹(dτ − ∂RNEA·(dq, dv))) to save work per tangent; the
    # derivative is the same function, so here the direct path is the one
    # implementation and ``fd_derivatives`` is the assembled implicit form.
    forward_dynamics = forward_dynamics_direct
    # parity alias with the reference model concept
    dynamics_aba = forward_dynamics_direct

    def fd_derivatives(self, q, v, tau):
        """(a, ∂a/∂q, ∂a/∂v, ∂a/∂τ) from ONE kinematics pass + ONE Cholesky:
        differentiate RNEA(q, v, a) = τ at the solution,

            [∂a/∂q | ∂a/∂v] = −M⁻¹ · ∂RNEA/∂(q, v),   ∂a/∂τ = M⁻¹,

        so the full Jacobian costs an (nq+nv)-column RNEA pushforward plus
        triangular solves.  The ∂/∂q block is a COORDINATE derivative:
        callers on quaternion-manifold models must chain it through the
        chart (the analytic Euler path gates on vector-space configurations
        instead — ocp/dynamics.py)."""
        nq, nv = self.nq, self.nv
        chol, a = self._factor_and_solve(q, v, tau)
        batch = chol.shape[:-2]
        qv = torch.cat(
            [q.expand(batch + (nq,)), v.expand(batch + (nv,))], dim=-1
        )
        dR = _batched_jacfwd(
            lambda qv_, a_: self.rnea(qv_[:nq], qv_[nq:], a_), qv, a
        )  # [..., nv, nq+nv]
        eye = torch.eye(nv, dtype=chol.dtype, device=chol.device).expand(batch + (nv, nv))
        rhs = torch.cat([-dR.to(chol.dtype), eye], dim=-1)
        sol = torch.cholesky_solve(rhs, chol).to(q.dtype)
        return a, sol[..., :nq], sol[..., nq : nq + nv], sol[..., nq + nv :]

    def energy(self, q, v) -> torch.Tensor:
        """Total mechanical energy (test oracle: conserved when unforced)."""
        kinetic = 0.5 * torch.sum(v * _mv(self.mass_matrix(q), v), dim=-1)
        Rs, ps = self.body_poses(q)
        potential = torch.zeros_like(kinetic)
        for i in range(self.nb):
            I = self.inertias[i]
            m = I[5, 5]
            # m·ĉ is the upper-right block; recover CoM offset
            mc_hat = I[:3, 3:]
            c = torch.stack([mc_hat[2, 1], mc_hat[0, 2], mc_hat[1, 0]])
            com_w = _mv(Rs[i], c / torch.clamp(m, min=1e-12)) + ps[i]
            potential = potential - m * torch.sum(self.gravity * com_w, dim=-1)
        return kinetic + potential


# ---------------------------------------------------------------------------
# model constructors
# ---------------------------------------------------------------------------


def build_model(
    joints: list,
    gravity=(0.0, 0.0, -9.81),
    frames: list | None = None,
    name: str = "robot",
    *,
    device: torch.device | str,
    dtype: torch.dtype,
) -> RobotModel:
    """Assemble a RobotModel from per-joint dicts:

    dict(type=..., parent=int, placement_rot=3×3, placement_trans=3,
         axis=3, mass=float, com=3, inertia=3×3,
         limit=dict(lower=, upper=, velocity=, effort=))  # optional, 1-DoF

    ``spatial_inertia=6×6`` in place of mass/com/inertia gives the body's
    spatial inertia about its origin directly (the URDF loader's accumulated
    link inertias).
    frames: list of dict(name=..., body=int, rot=3×3, trans=3).
    """
    f64 = np.float64
    jp_rot = np.stack([np.asarray(j.get("placement_rot", np.eye(3)), f64) for j in joints])
    jp_trans = np.stack([np.asarray(j.get("placement_trans", np.zeros(3)), f64) for j in joints])
    axes = np.stack([np.asarray(j.get("axis", [0.0, 0.0, 1.0]), f64) for j in joints])
    # normalize axes for revolute-family joints
    axes = axes / np.maximum(np.linalg.norm(axes, axis=1, keepdims=True), 1e-12)
    inertias = np.stack(
        [
            np.asarray(j["spatial_inertia"], f64)
            if "spatial_inertia" in j
            else spatial_inertia(
                j.get("mass", 1.0),
                j.get("com", np.zeros(3)),
                j.get("inertia", np.eye(3) * 1e-3),
            ).numpy()
            for j in joints
        ]
    )
    frames = frames or []
    nf = len(frames)
    frame_rot = (
        np.stack([np.asarray(f.get("rot", np.eye(3)), f64) for f in frames])
        if nf else np.zeros((0, 3, 3))
    )  # fmt: skip
    frame_trans = (
        np.stack([np.asarray(f.get("trans", np.zeros(3)), f64) for f in frames])
        if nf else np.zeros((0, 3))
    )  # fmt: skip

    joint_types = tuple(j["type"] for j in joints)
    nq = sum(JOINT_DIMS[t][0] for t in joint_types)
    nv = sum(JOINT_DIMS[t][1] for t in joint_types)

    # joint limits: scatter per-joint 1-DoF limit dicts into the q/v layout;
    # unlimited (multi-DoF, continuous-position, absent) slots stay ±inf
    q_lower = np.full(nq, -np.inf)
    q_upper = np.full(nq, np.inf)
    v_limit = np.full(nv, np.inf)
    tau_limit = np.full(nv, np.inf)
    qo = vo = 0
    for j, t in zip(joints, joint_types):
        dq, dv = JOINT_DIMS[t]
        lim = j.get("limit")
        if lim and dv == 1:
            if t in ("revolute", "prismatic"):
                if lim.get("lower") is not None:
                    q_lower[qo] = float(lim["lower"])
                if lim.get("upper") is not None:
                    q_upper[qo] = float(lim["upper"])
            if lim.get("velocity") is not None:
                v_limit[vo] = float(lim["velocity"])
            if lim.get("effort") is not None:
                tau_limit[vo] = float(lim["effort"])
        qo += dq
        vo += dv

    def tt(x):
        return torch.tensor(np.asarray(x, f64), dtype=dtype, device=device)

    return RobotModel(
        jp_rot=tt(jp_rot),
        jp_trans=tt(jp_trans),
        axes=tt(axes),
        inertias=tt(inertias),
        gravity=tt(gravity),
        frame_rot=tt(frame_rot),
        frame_trans=tt(frame_trans),
        damping=tt(np.zeros(nv)),
        joint_types=joint_types,
        parents=tuple(j["parent"] for j in joints),
        frame_bodies=tuple(f["body"] for f in frames),
        frame_names=tuple(f.get("name", f"frame{k}") for k, f in enumerate(frames)),
        name=name,
        q_lower=tt(q_lower),
        q_upper=tt(q_upper),
        v_limit=tt(v_limit),
        tau_limit=tt(tau_limit),
    )


def all_joints_test_model(*, device, dtype) -> RobotModel:
    """Synthetic model covering every Lie-group joint type (freeflyer +
    spherical + planar, extended with the remaining types)."""
    joints = [
        dict(type="freeflyer", parent=-1, mass=2.0, com=[0.05, 0.0, 0.1], inertia=np.diag([0.02, 0.03, 0.025])),
        dict(type="spherical", parent=0, placement_trans=[0.2, 0.0, 0.0], mass=1.0, com=[0.0, 0.0, 0.15], inertia=np.diag([0.01, 0.012, 0.008])),
        dict(type="planar", parent=1, placement_trans=[0.0, 0.1, 0.0], mass=0.5, com=[0.1, 0.0, 0.0], inertia=np.diag([0.005, 0.006, 0.004])),
        dict(type="revolute", parent=2, placement_trans=[0.1, 0.0, 0.0], axis=[0.0, 1.0, 0.0], mass=0.7, com=[0.0, 0.0, 0.2], inertia=np.diag([0.004, 0.005, 0.003])),
        dict(type="continuous", parent=3, placement_trans=[0.0, 0.0, 0.3], axis=[1.0, 0.0, 0.0], mass=0.4, com=[0.0, 0.1, 0.0], inertia=np.diag([0.002, 0.003, 0.0025])),
        dict(type="prismatic", parent=4, placement_trans=[0.0, 0.1, 0.0], axis=[0.0, 0.0, 1.0], mass=0.3, com=[0.0, 0.0, 0.05], inertia=np.diag([0.001, 0.001, 0.001])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=5, trans=[0.0, 0.0, 0.1])]
    return build_model(joints, frames=frames, name="all_joints", device=device, dtype=dtype)


def double_pendulum(*, device, dtype) -> RobotModel:
    """Planar double pendulum (two y-axis revolute joints)."""
    joints = [
        dict(type="revolute", parent=-1, axis=[0.0, 1.0, 0.0], mass=1.0, com=[0.0, 0.0, -0.5], inertia=np.diag([0.05, 0.05, 1e-4])),
        dict(type="revolute", parent=0, placement_trans=[0.0, 0.0, -1.0], axis=[0.0, 1.0, 0.0], mass=1.0, com=[0.0, 0.0, -0.5], inertia=np.diag([0.05, 0.05, 1e-4])),
    ]  # fmt: skip
    frames = [dict(name="tip", body=1, trans=[0.0, 0.0, -1.0])]
    return build_model(joints, frames=frames, name="double_pendulum", device=device, dtype=dtype)
