"""Mimic-joint (gear/linkage) reduction: a reduced-coordinate model wrapper
(≙ ddp_tpu/models/reduced.py).

URDF ``<mimic joint="master" multiplier="c" offset="o"/>`` declares a joint
whose position is slaved to another: q_mimic = c·q_master + o.  The model
surface exposes the independent (master) coordinates; the full model keeps
the kinematics and dynamics, related by a constant linear coupling

    q_full = C · q_red + d,      v_full = C · v_red.

Projected (gear-reduced) dynamics:

    M_red(q)   = Cᵀ M_full(q_full) C
    FD:  a_red  = M_red⁻¹ (τ_red − Cᵀ rnea_full(q_full, C v_red, 0))
    ID:  τ_red  = Cᵀ rnea_full(q_full, C v_red, C a_red)

Every joint of the full model must be revolute or prismatic.  The wrapper
has no ``fd_derivatives`` and no ``joint_types``: the derivative layer
takes its generic path for it, and ``deriv="kernel"`` refuses it.  Every
method takes any number of leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ddp_tpu_torch.models.rigid_body import RobotModel


class ReducedModel(nn.Module):
    """Reduced-coordinate wrapper over a RobotModel with slaved joints;
    ``coupling`` C [nv_full, nv_red] and ``offset`` d [nq_full] are buffers."""

    def __init__(self, full: RobotModel, coupling: torch.Tensor, offset: torch.Tensor):
        super().__init__()
        self.full = full
        self.register_buffer("coupling", coupling)
        self.register_buffer("offset", offset)

    # ---- dims ----
    @property
    def nb(self) -> int:
        return self.full.nb

    @property
    def nq(self) -> int:
        return self.coupling.shape[1]

    @property
    def nv(self) -> int:
        return self.coupling.shape[1]

    @property
    def nu(self) -> int:
        return self.nv

    @property
    def dtype(self) -> torch.dtype:
        return self.full.dtype

    @property
    def device(self) -> torch.device:
        return self.full.device

    @property
    def name(self) -> str:
        return self.full.name

    @property
    def frame_names(self):
        return self.full.frame_names

    # ---- coordinate maps ----
    def q_full(self, q: torch.Tensor) -> torch.Tensor:
        return q @ self.coupling.T + self.offset

    def v_full(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.coupling.T

    # ---- configuration space (a vector space by construction) ----
    def neutral_configuration(self) -> torch.Tensor:
        return torch.zeros((self.nq,), dtype=self.dtype, device=self.device)

    def random_configuration(self, generator: torch.Generator) -> torch.Tensor:
        q = torch.randn(self.nq, generator=generator, dtype=self.dtype, device=generator.device)
        return 0.5 * q.to(self.device)

    def integrate(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        return q + dq

    def difference(self, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
        return q1 - q0

    # ---- frames ----
    def frame_position(self, frame_id: int, q: torch.Tensor) -> torch.Tensor:
        return self.full.frame_position(frame_id, self.q_full(q))

    # ---- dynamics (projected) ----
    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        C = self.coupling
        return C.T @ self.full.mass_matrix(self.q_full(q)) @ C

    def rnea(self, q: torch.Tensor, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        C = self.coupling
        return self.full.rnea(self.q_full(q), self.v_full(v), self.v_full(a)) @ C

    def forward_dynamics(self, q: torch.Tensor, v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        C = self.coupling
        qf, vf = self.q_full(q), self.v_full(v)
        bias = self.full.rnea(qf, vf, torch.zeros_like(vf)) @ C
        M_red = C.T @ self.full.mass_matrix(qf) @ C
        # M_red is SPD: a Cholesky solve, as RobotModel's (and no
        # torch.linalg.solve, whose forward-mode derivative under vmap with
        # more than one sample came out wrong in PyTorch 2.13 on the CPU).
        # A non-PD M_red gives non-finite accelerations and never raises.
        chol, _ = torch.linalg.cholesky_ex(M_red)
        return torch.cholesky_solve((tau - bias)[..., None], chol)[..., 0]

    # ---- limits (master selection) ----
    @property
    def q_lower(self):
        return self._select_limit(self.full.q_lower)

    @property
    def q_upper(self):
        return self._select_limit(self.full.q_upper)

    @property
    def v_limit(self):
        return self._select_limit(self.full.v_limit)

    @property
    def tau_limit(self):
        return self._select_limit(self.full.tau_limit)

    def _select_limit(self, lim):
        if lim is None:
            return None
        # master column k owns exactly one unit row; pick that row's limit
        idx = (self.coupling.abs() == 1.0).to(torch.int32).argmax(dim=0)
        return lim[idx]


def reduce_mimic(
    full: RobotModel, masters: list[int], mimic: dict[int, tuple[int, float, float]]
) -> ReducedModel:
    """Build a ReducedModel on the full model's device and dtype.

    ``masters``: full-model joint indices that stay independent (their order
    is the reduced layout).  ``mimic``: full index → (master full index,
    multiplier, offset).  Every joint must be 1-DoF and vector-space."""
    for t in full.joint_types:
        if t not in ("revolute", "prismatic"):
            raise ValueError(f"mimic reduction needs all joints revolute/prismatic, got {t}")
    nvf, nvr = full.nv, len(masters)
    col = {m: k for k, m in enumerate(masters)}
    C = np.zeros((nvf, nvr))
    d = np.zeros(nvf)
    for m, k in col.items():
        C[m, k] = 1.0
    for j, (m, mult, off) in mimic.items():
        C[j, col[m]] = mult
        d[j] = off
    kw = dict(dtype=full.dtype, device=full.device)
    return ReducedModel(full, torch.tensor(C, **kw), torch.tensor(d, **kw))
