"""Quaternion / SO(3) / SE(3)-adjacent primitives (≙ ddp_tpu/ops/lie.py).

Jacobians are never hand-written here: the solver obtains them with
``torch.func.jacfwd`` through these ops.

Quaternion convention: (w, x, y, z), unit norm, Hamilton product.  Every op
takes any number of leading batch dims, has no data-dependent control flow
and stays numerically safe at the identity via Taylor-guarded small-angle
branches.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """exp: R³ (rotation vector) → unit quaternion.  Taylor-safe at 0."""
    theta2 = torch.sum(v * v, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    half = 0.5 * theta
    # sin(θ/2)/θ with series fallback: 1/2 - θ²/48 + ...
    small = theta2 < 1e-8
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, s * v], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """log: unit quaternion → rotation vector in (−π, π]."""
    w = q[..., :1]
    xyz = q[..., 1:]
    # force w >= 0 (shortest arc): q and −q are the same rotation
    sign = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    w, xyz = w * sign, xyz * sign
    n2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    n = torch.sqrt(n2 + _EPS)
    angle = 2.0 * torch.atan2(n, w)
    small = n2 < 1e-8
    # angle/sin(angle/2) ≈ 2/w · (1 − n²/(3w²)) near identity
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5) * (1.0 - n2 / 3.0), angle / n)
    return scale * xyz


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by a unit quaternion (active rotation)."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    t = 2.0 * torch.linalg.cross(u, v, dim=-1)
    return v + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (w ≥ 0), branch-free (Shepperd via
    four candidates + select)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw = torch.stack([safe_sqrt(1 + tr), m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, safe_sqrt(1 + m00 - m11 - m22), m10 + m01, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m10 + m01, safe_sqrt(1 - m00 + m11 - m22), m21 + m12], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m21 + m12, safe_sqrt(1 - m00 - m11 + m22)], -1)
    # pick the numerically best candidate
    scores = torch.stack([tr, m00, m11, m22], -1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    pick = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, pick)[..., 0, :]
    # candidate k needs division by its diagonal sqrt term; normalize instead
    q = quat_normalize(q)
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    return q * sign


def so2_integrate(cs: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Rotate a (cos, sin) pair by dtheta (unbounded-revolute / planar)."""
    c, s = cs[..., 0], cs[..., 1]
    dc, ds = torch.cos(dtheta), torch.sin(dtheta)
    return torch.stack([c * dc - s * ds, s * dc + c * ds], dim=-1)


def so2_difference(cs0: torch.Tensor, cs1: torch.Tensor) -> torch.Tensor:
    """Angle of R0ᵀ R1 for (cos, sin) pairs; in (−π, π]."""
    c0, s0 = cs0[..., 0], cs0[..., 1]
    c1, s1 = cs1[..., 0], cs1[..., 1]
    return torch.atan2(s1 * c0 - c1 * s0, c1 * c0 + s1 * s0)


def hat(v: torch.Tensor) -> torch.Tensor:
    """3-vector → skew-symmetric matrix (v×)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )
