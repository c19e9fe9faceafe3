"""Batched forward-dynamics derivative blocks (≙ ddp_tpu/kernels/fd_derivs.py).

Per sample (q, v, τ) of a tree robot with revolute/prismatic joints:

    a = M⁻¹(τ − bias),  ∂a/∂q = −M⁻¹(∂_q bias + (∂_q M)·a),
    ∂a/∂v = −M⁻¹ ∂_v bias,  ∂a/∂τ = M⁻¹

— the implicit-function scheme of ``RobotModel.fd_derivatives`` with the
kinematics → composite bodies → RNEA chain walked once per tangent
direction.  ``fd_derivs`` runs the CUDA kernel ``csrc/fd_derivs.cu`` on CUDA
tensors (one thread per sample and tangent direction; the model's constants
are data uploaded by the wrapper, so one compiled source serves every model
with the same joint count) and the plain PyTorch version
``fd_derivs_reference`` on CPU tensors.  The plain version follows the
kernel's algorithm step by step, so the two compare tightly on the card.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
from torch.func import jvp, vmap

from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels.riccati_small import _chol_solve
from ddp_tpu_torch.models.rigid_body import _block2, _mv
from ddp_tpu_torch.ops import lie

SOURCE = "fd_derivs.cu"
# joint counts the CUDA source instantiates (each for float and double):
# cartpole/acrobot, UR5-class arms, panda7
KERNEL_NV = (2, 6, 7)
# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

_JOINT_CODE = {"revolute": 0, "prismatic": 1}
# model → {(device, dtype): (topo, consts)}: the kernel's view of a model is
# uploaded once and reused by every later launch.  A model whose buffers are
# edited in place afterwards needs ``forget_model``.
_CONSTANTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def check_model(model) -> int:
    """The kernel's model gate: revolute/prismatic joints only (1-DoF,
    vector-space configuration — the analytic-Jacobian gate of
    ocp/dynamics.py).  Returns nv."""
    jt = tuple(model.joint_types)
    if not all(t in _JOINT_CODE for t in jt):
        raise ValueError(f"fd_derivs supports revolute/prismatic joints; got {jt}")
    return len(jt)


def pack_inputs(q: torch.Tensor, v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """[N, nv] × 3 → the kernel's sample-last [3·nv, N] (q, v, τ rows)."""
    return torch.cat([q, v, tau], dim=1).T.contiguous()


def unpack_outputs(a_t, Aq_t, Av_t, Mi_t):
    """The kernel's [nv, N] and [nv·nv, N] outputs → (a [N, nv],
    ∂a/∂q, ∂a/∂v, M⁻¹ each [N, nv, nv])."""
    nv, N = a_t.shape
    return (
        a_t.T,
        Aq_t.T.reshape(N, nv, nv),
        Av_t.T.reshape(N, nv, nv),
        Mi_t.T.reshape(N, nv, nv),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _chain_M_bias(model, q, v):
    """The kernel's chain on [N, nv] tensors: (M [N, nv, nv] symmetric,
    bias [N, nv] = RNEA(q, v, 0) with gravity and damping)."""
    jt, par = model.joint_types, model.parents
    nb = len(jt)
    N = q.shape[0]
    kw = dict(dtype=q.dtype, device=q.device)
    I3 = torch.eye(3, **kw)
    z3 = torch.zeros(3, **kw)
    a0 = torch.cat([z3, -model.gravity])
    Rw, pw, Sw, IC, vb, ab, fb = ([None] * nb for _ in range(7))
    for i in range(nb):
        ax, Ep, rp = model.axes[i], model.jp_rot[i], model.jp_trans[i]
        if jt[i] == "revolute":
            K = lie.hat(ax)
            c, s = torch.cos(q[:, i]), torch.sin(q[:, i])
            R = I3 + s[:, None, None] * K + (1.0 - c)[:, None, None] * (K @ K)
            E, rj = R.mT, torch.zeros(N, 3, **kw)
            s_ang, s_lin = ax, z3
        else:  # prismatic
            E, rj = I3.expand(N, 3, 3), q[:, i : i + 1] * ax
            s_ang, s_lin = z3, ax
        # compose the fixed placement: Ef = E·Ep, r = rp + Epᵀ·rj
        Ef = E @ Ep
        r = rp + rj @ Ep
        p = par[i]
        if p < 0:
            Rw[i], pw[i] = Ef.mT, r
        else:
            Rw[i], pw[i] = Rw[p] @ Ef.mT, _mv(Rw[p], r) + pw[p]
        sa = _mv(Rw[i], s_ang)
        Sw[i] = torch.cat([sa, _cross(pw[i], sa) + _mv(Rw[i], s_lin)], dim=-1)
        # world spatial inertia Iw = Xᵀ I X, X = [[Rᵀ, 0], [−Rᵀp̂, Rᵀ]]
        Rt = Rw[i].mT
        X = _block2(Rt, torch.zeros_like(Rt), -(Rt @ lie.hat(pw[i])), Rt)
        IC[i] = X.mT @ (model.inertias[i] @ X)
        # velocities and bias accelerations down the tree
        sv = Sw[i] * v[:, i : i + 1]
        vb[i] = sv if p < 0 else vb[p] + sv
        w, vl = vb[i][:, :3], vb[i][:, 3:]
        psi = torch.cat(
            [_cross(w, sv[:, :3]), _cross(vl, sv[:, :3]) + _cross(w, sv[:, 3:])], dim=-1
        )
        ab[i] = (a0 if p < 0 else ab[p]) + psi
        Ivb = _mv(IC[i], vb[i])
        fb[i] = _mv(IC[i], ab[i]) + torch.cat(
            [_cross(w, Ivb[:, :3]) + _cross(vl, Ivb[:, 3:]), _cross(w, Ivb[:, 3:])], dim=-1
        )
    # composite inertias and subtree forces up the tree
    for i in reversed(range(nb)):
        p = par[i]
        if p >= 0:
            IC[p] = IC[p] + IC[i]
            fb[p] = fb[p] + fb[i]
    zero = torch.zeros(N, **kw)
    Mij = [[zero] * nb for _ in range(nb)]
    bias = [None] * nb
    for j in range(nb):
        u = _mv(IC[j], Sw[j])
        i = j
        while i >= 0:  # only ancestors of j couple with it
            Mij[i][j] = Mij[j][i] = torch.sum(Sw[i] * u, dim=-1)
            i = par[i]
        bias[j] = model.damping[j] * v[:, j] + torch.sum(Sw[j] * fb[j], dim=-1)
    M = torch.stack([torch.stack(row, dim=-1) for row in Mij], dim=-2)
    return M, torch.stack(bias, dim=-1)


def fd_derivs_reference(model, q, v, tau):
    """Plain PyTorch version of the kernel on [N, nv] tensors: the same
    chain, one forward-mode tangent per column of (q, v), the same unrolled
    Cholesky.  Returns (a [N, nv], ∂a/∂q, ∂a/∂v, M⁻¹ each [N, nv, nv])."""
    nv = check_model(model)
    N = q.shape[0]
    eye = torch.eye(2 * nv, dtype=q.dtype, device=q.device)

    def one_direction(e):
        return jvp(
            lambda q_, v_: _chain_M_bias(model, q_, v_),
            (q, v),
            (e[:nv].expand(N, nv), e[nv:].expand(N, nv)),
        )

    (Ms, biases), (dM, dbias) = vmap(one_direction)(eye)
    M, bias = Ms[0], biases[0]
    a = _chol_solve(M, (tau - bias)[..., None], 0.0)[0][..., 0]
    # rhs_c = −(∂_c bias + (∂_c M)·a), one column per tangent direction
    rhs = -(dbias + torch.einsum("cnij,nj->cni", dM, a)).permute(1, 2, 0)
    unit = torch.eye(nv, dtype=q.dtype, device=q.device).expand(N, nv, nv)
    sol = _chol_solve(M, torch.cat([rhs, unit], dim=-1), 0.0)[0]
    return a, sol[..., :nv], sol[..., nv : 2 * nv], sol[..., 2 * nv :]


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def fd_derivs(model, q, v, tau):
    """Batched (a, ∂a/∂q, ∂a/∂v, M⁻¹) for [N, nv] inputs, any N: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Returns
    (a [N, nv], A [N, nv, nv], Bv [N, nv, nv], Minv [N, nv, nv])."""
    check_model(model)
    if q.device.type == "cpu":
        return fd_derivs_reference(model, q, v, tau)
    return _launch(model, q, v, tau)


def _model_constants(model, dtype, device):
    """(topo int32 [2·nv] = joint codes then parents, consts [52·nv + 3] =
    axes, jp_rot, jp_trans, inertias, gravity, damping) in the kernel's
    layout, built on the first call for (device, dtype) and cached."""
    cache = _CONSTANTS.setdefault(model, {})
    key = (torch.device(device), dtype)
    if key not in cache:
        if any(p >= i for i, p in enumerate(model.parents)):
            raise ValueError("fd_derivs needs every parent to precede its children")
        codes = [_JOINT_CODE[t] for t in model.joint_types]
        topo = torch.tensor(codes + list(model.parents), dtype=torch.int32, device=device)
        consts = torch.cat(
            [
                x.reshape(-1)
                for x in (
                    model.axes, model.jp_rot, model.jp_trans, model.inertias,
                    model.gravity, model.damping,
                )
            ]
        ).to(device=device, dtype=dtype)  # fmt: skip
        cache[key] = (topo, consts.contiguous())
    return cache[key]


def forget_model(model) -> None:
    """Drop the cached constants of ``model`` (after an in-place edit of its
    buffers); the next launch uploads them again."""
    _CONSTANTS.pop(model, None)


def _launch(model, q, v, tau):
    global LAUNCHES
    nv = len(model.joint_types)
    if nv not in KERNEL_NV:
        raise ValueError(f"no CUDA instantiation for nv={nv}; have {KERNEL_NV}")
    N, dtype, dev = q.shape[0], q.dtype, q.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    for name, x in (("q", q), ("v", v), ("tau", tau)):
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} on {dev}")
        if tuple(x.shape) != (N, nv):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {(N, nv)}")
    a_t = torch.empty((nv, N), dtype=dtype, device=dev)
    Aq_t, Av_t, Mi_t = (torch.empty((nv * nv, N), dtype=dtype, device=dev) for _ in range(3))
    if N == 0:  # nothing to launch, and nothing to count
        return unpack_outputs(a_t, Aq_t, Av_t, Mi_t)
    fn = _kernel_fn()
    topo, consts = _model_constants(model, dtype, dev)
    qvu = pack_inputs(q, v, tau)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            int(dtype == torch.float64), nv, N, topo.data_ptr(), consts.data_ptr(),
            qvu.data_ptr(), a_t.data_ptr(), Aq_t.data_ptr(), Av_t.data_ptr(),
            Mi_t.data_ptr(), stream,
        )  # fmt: skip
    if rc != 0:
        raise RuntimeError(f"fd_derivs kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return unpack_outputs(a_t, Aq_t, Av_t, Mi_t)


def _kernel_fn():
    lib = _build.load(SOURCE)
    fn = lib.ddp_fd_derivs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn
